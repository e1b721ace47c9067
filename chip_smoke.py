#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the nine hand-written kernels from the repository's .cu sources
(one nvcc each, in parallel), holds each against its plain PyTorch version
on the card, and drives the port's three index paths at the irli-deep1b
widths, the LM prefill, decode and the IRLI vocabulary head at gemma-7b's,
the MoE block at mixtral-8x7b's and llama4-maverick's, and DIEN's serve
path at its own:

  * search (Alg. 2) through ``IRLIIndex.search``: the compact path
    (``mode="compact"``, int8 store: irli_topk, freq_topc and quant_rerank,
    one launch each) and the fused path (``mode="auto"``, which resolves to
    ``"mega"`` here: one launch of mega_query and no other kernel, by the
    counters and a torch.profiler trace), then the other store kinds, l2,
    adaptive m and an exact tier at Q = 64;
  * the stream cell (``stream_cell``): ``MutableIRLIIndex`` over the search
    cell's index (capacity 2·L = 4,000,000, delta_len 208, int8 store): 16
    insert batches of 4096 seeded vectors (one irli_topk and one kchoice
    launch each), 100,000 deletes (90,000 base ids, 10,000 inserted), a
    search (``mode="auto"`` -> "mega", which the delta and tombstone state
    send to the compact kernels), ``compact()``, the search again (bit-equal
    to the first), and ``exact_oracle(k=10)`` (one distance_topk launch, no
    [Q, L] table: its peak memory above its inputs must stay under 85 MB);
    the search is held against the plain search on the same snapshot, the
    oracle against the plain oracle, no deleted id may come back, and at
    least 99% of 1024 sampled live inserted vectors must return their own id
    at rank 0. distance_topk is also held against its plain version at
    Q = 64 with l2, at d = 768 (its query tile streamed), in a dense search
    over the fit cell's index (L = 131,072) and on one chunk of
    ``neighbours`` (k = 100), whose time is held to NEIGHBOURS_MS_MAX. The
    checkpoint of the 4 GB state is not written on the card (the CPU tests
    round-trip it);
  * the server cell (``server_cell``): ``IRLIServer`` (max_batch 512,
    max_wait 2 ms, the probe counter on) over the search cell's index and
    int8 store at the search cell's SearchParams (mode "auto"), one request
    in eight at m = 10 as launch/serve.py's wide override: a burst of
    N_BURST requests from one client thread (queries/s over the wall clock
    from the first submit to the last result, p50/p99 from submit to
    result, batches, pad waste, param groups, cache compiles), the
    burst's first N_BARE requests without the probe counter (its irli_topk
    a batch), N_PACED requests at seeded Poisson arrivals at half the
    burst's rate, then a server over the stream cell's index with an insert of MUT_INSERT rows
    after every MUT_EVERY of N_MUT_Q queries and a delete of N_MUT_DEL live
    ids after the second; every served row bit-equal to a direct search of
    its padded batch (the mutation phase's at the snapshot the batch
    read), held to the plain search, the probe counter's sum, each batch's
    launches, each query's epoch that of the last mutation before it;
  * the refit cell (``refit_cell``): a hash-partitioned index at the
    deep1b widths (R = REFIT_R = 16) over FIT_L labels (sigmoid_bce), a
    MutableIRLIIndex
    (int8, capacity 2L, delta_len 208) served through IRLIServer with a
    QueryLog, a ShadowAuditor over the exact oracle (sample 0.05) and a
    DriftDetector, inserts and deletes through the server, one
    ``OnlineRefitLoop`` cycle (bce_logits, irli_topk and kchoice; rows
    inserted while it runs re-placed by the swap: irli_topk and kchoice);
    the fit, cycle, swap-pause and build_replicas times, the artifact's ML
    and live maximum load, verify(), a save/restore with the digest equal,
    the epochs after the swap, >= 99% of the tail finding itself, no
    deleted id, staged = unstaged, a hot-replica search;
  * the distributed cell (``dist_cell``, core/distributed.py): (a) an NCCL
    process group of world size 1 in this process: ``launch/steps.
    build_irli_serve`` and ``make_production_search`` over the search
    cell's index, int8 store and queries, bit-equal to the compact search
    (ids, n_candidates, scores) and timed beside it (the difference is the
    merge's cost), then the fit cell's config over DIST_FIT_L = 32,768
    labels, one round, through ``IRLIIndex.fit(mesh=)`` on a 1 x 1
    ("data", "rep") mesh, bit-equal to the fit without one (assign,
    losses, params, AdamW moments); (b) DIST_P = 4 gloo ranks spawned on
    the one card (NCCL refuses two ranks on one device), each with
    DIST_L = 500,000 rows of the same corpus under its own hash partition
    (max_load 2·⌈DIST_L/B⌉ = 50), the replicated scorer and the same
    queries: every rank's result equal to this process's loop over the
    shards through ``shard_search_local`` merged by a stable sort on the
    host (ids and n_candidates exactly, scores bit-equal); the ranks
    time-share the card, so their times are correctness only; (c) in the
    same ranks the fit on a 2 x 2 ("data", "rep") mesh at narrow widths (B
    = 2000, R = 4, H = 256, NARROW_L = 8192 labels, 2 rounds), held to the
    single-device fit here with tests/test_fit_engine.py's tolerances (loss
    rtol 1e-4, assign match > 0.98, load_std rtol 0.05);
  * the audit cell (``audit_cell``, analysis/ and launch/audit.py): (a)
    every registered static contract at the reference's fixture sizes on
    the card, the two mesh contracts in a world of 4 gloo ranks spawned on
    it, every control tripped, the sightings a kernel keeps on chip
    listed (each counted only when that kernel launched in the call),
    query.mega_single_dispatch exactly one CUDA kernel (mega_query, by
    torch.profiler) and its staged control more than one, the fit round's
    backward in the op record; (b) the four seeded violations, each
    detected; (c) at full width, the search cell's index and int8 store at
    Q = AUDIT_Q = 1000 (the compact search: no [Q, L] table, no fp32 [L,
    D] or [Q, C, D]; IRLIIndex.search at mode "auto" -> "mega": one
    dispatch, one CUDA kernel) and the distributed cell's cut of the fit
    (32,768 labels, one round, label chunks of 8,192): no [.., L, B], the
    state overwritten in place. Each contract's verdict, peak intermediate
    and time are logged;
  * the fit (Alg. 1) through ``IRLIIndex.fit``, ANN mode, sigmoid_bce: per
    train step one bce_logits launch, per affinity label chunk one
    irli_topk launch, per round one kchoice launch; its round 1 again with
    the plain versions in place of the three kernels (no launch), held
    against the kernel fit's round 1; then one round of a softmax_bce fit
    (the paper's loss: no bce_logits); recall@10 of the fitted index
    against exact search, above the hash partition's; the partition
    baselines (``baselines_phase``, core/baselines.py) on the fit's data:
    k-means and LSH at B buckets and the random partition through their
    query -> bucket rules, the candidate mask and recall@10 at m = 1, 4,
    16 beside the fitted index's candidates, and balanced k-means at
    BALANCED_L = 8,192 labels, BALANCED_B = 64 (its walk on the host);
  * the train cell (``train_cell``, after the fit): (a) the fault-tolerant
    ``Trainer`` (train/trainer.py) over ``launch/steps.
    build_irli_fit_parts`` at the fit cell's config with R cut to TRAIN_R
    = 2, TRAIN_ROUNDS = 3 rounds of 1 epoch, a checkpoint every 2:
    uninterrupted, then crashed before round 2 (``fail_at_step``) and
    resumed from its checkpoint, assign, params and the last round's loss
    bit-equal to the uninterrupted run; the round times (after
    ``torch.cuda.synchronize``), each checkpoint's write and the restore
    seconds and its bytes; one bce_logits launch a train step, one
    irli_topk an affinity chunk, one kchoice a round; (b) the mesh Trainer
    on DIST_P gloo ranks on the card (the distributed cell's ranks, which
    run it after their own work; ``--train`` spawns its own) at that
    cell's narrow widths: 3 rounds on a 2 x 2 ("data", "rep") mesh, then
    crashed on 2 x 2 and resumed on 1 x 4 from the whole-state checkpoint,
    held to the uninterrupted run with the mesh fit's tolerances (last
    loss rtol 1e-4, assign match > 0.98, params rtol 1e-3); (c)
    ``build_retrieval_serve`` at DIEN's ``retrieval_cand`` (query [1,
    36], item table [1,048,576, 36] fp32, k = 100): one distance_topk
    launch ("dot"), held to its plain version, timed beside it,
    torch.topk over torch.mm and its byte bound; (d) ``launch/obs_smoke.
    main(device="cuda")``, whose own asserts hold every metric family;
    (e) each TMA kernel (mega_query, irli_topk, distance_topk,
    flash_attention) launched 20 times from a new thread that never set a
    device, after 300 launches of its toy call and 1,000 of irli_topk's
    here, bit-equal to this thread's results (kernels/tma.cuh binds the
    thread's CUDA context before it encodes a tensor map);
  * the LM prefill cell (``lm_cell``): ``launch/steps.build_lm_prefill``
    over gemma-7b at full width and full depth (28 layers, d 3072, 16
    heads x 256, d_ff 24576, vocab 256,000, bf16, random weights from
    ``lm_init`` seeded SEED on the card) at [4, 2048] and [1, 32768]: one
    flash_attention launch a layer and no other kernel; flash_attention
    against its plain version on layer 0's real q, k and v (bf16, and fp32
    at [4, 2048]; bf16 rtol/atol 3e-2, fp32 2e-4, the reference test's),
    its error against the fp32-probability attention at most 1.25x the
    plain version's; each prefill against the same prefill with the plain
    attention (``plain_attention``: the last hidden state's relative L2
    error <= PREFILL_TOL = 5e-2, and against the prefill with fp32
    probabilities at most 1.25x the plain prefill's; next tokens equal
    except rows whose plain top-2 gap is under 2e-2·|top|, counted); the
    attention call's peak memory above its inputs and output under 64 MB;
    prefill times, the device time of one traced prefill by launching op
    (``device_split``: the attention's share) and the prefill's FLOP
    bound; the kernel's time beside its bound, its plain version's and
    scaled_dot_product_attention's (TFLOP/s and the kernel/SDPA ratio).
    Then, on gemma-7b's model, its decode (``decode_phase``:
    ``build_lm_decode`` at B = DECODE_B over ``init_cache`` at context
    DECODE_CTX, 15.0 GB; 16 steps from pos 0 held to the teacher-forced
    forward, each step's logits within DECODE_TOL = 5e-2 relative L2 and
    next tokens equal outside near ties; a step timed at pos DECODE_POS of
    a cache filled with random bf16 values beside its byte bound, and
    traced) and the IRLI vocabulary head (``head_phase``: V = 256,000
    tokens, the hash partition at HEAD_B = 4096 buckets, HEAD_R = 4 reps,
    max_load 125, a random softmax_bce scorer of width HEAD_H = 1024, m =
    HEAD_M = 8: 4,000 candidates a query) on the [4, 2048] prefill's last
    hidden state and the first decode step's: the probe one irli_topk
    launch, held to top_buckets outside near ties at the m cut, the
    candidate ids to the plain gather, every candidate logit to the full
    head's (TOL), the greedy token to the full head's argmax over the
    candidates; its time and bytes beside the full head's. Then qwen3-4b
    at full width, 4 of its 36 layers, at [4, 2048] (GQA, 32 heads over
    8, head_dim 128), held and timed the same way. The bf16 kernel's
    registers, spill bytes (0, a gate) and shared memory at each padded
    head_dim come first (``cudaFuncGetAttributes``);
  * the MoE cell (``moe_cell``): mixtral-8x7b at full width, MOE_LAYERS =
    4 of its 32 layers (12.1 GB of random bf16 weights from SEED), under
    its top-k router and under ``router="irli_kchoice"`` (one kchoice
    launch a layer, ``slots = 2``): the prefill at [1, MOE_SEQ = 8192]
    (the 4096-token window masks real keys), every k-choice routing
    bit-equal to ``kchoice_ref(slots=2)`` on its router logits, layer 0's
    block routed by the kernel bit-equal to the block routed by the plain
    walk (``plain_router``); decode at B = DECODE_B over a ring of 4096
    slots filled with the forward's K and V of positions 0..MOE_POS - 1,
    16 steps across pos 4096 (the ring wraps), held under top-k to the
    teacher-forced forward (run a row at a time at capacity E / top_k,
    where no token is dropped; ``decode_routing_gate``: a token routed as
    the forward in every layer within DECODE_TOL, a token routed
    otherwise only where the forward's router had a near tie); under
    k-choice only its routings are held (its loads run over the whole
    block in the forward and over one step in decode); ``_moe_rows`` at
    [2, MOE_ROWS_T] (ffn_chunk MOE_ROWS_T) routing as each row alone.
    Then llama4-maverick's MoE block alone at full width (128 experts of
    [5120, 8192] and a shared one, 32.5 GB) on a [1, LLAMA4_T = 2048] bf16
    activation under both routers: kchoice at E = 128, slots 1, bit-equal
    to its plain version, and the kernel-routed output bit-equal to the
    plain-routed one; each with its time and the largest expert's share;
  * the recsys cell (``recsys_cell``): ``launch/steps.build_ctr_serve``
    over DIEN at ``configs/dien.CONFIG``'s full width (item table
    1,048,576 x 18 and category table 100,000 x 18 fp32, sequence 100,
    GRU 108, MLP 200-80; random weights from ``dien_init`` seeded SEED on
    the card) at the reference's serve_p99 (B = 512) and serve_bulk
    (B = 262,144) batches from ``behavior_stream`` (seed SEED): two
    embedding_bag launches a forward (the item and the category history
    sums) and no other kernel; the kernel against its plain version on
    each batch's ids and mask for both tables (fp32, TOL); prob against
    the same forward with the plain history sum (``plain_bags``; TOL: only
    the summation order of the history sum differs); the warm forward's
    time, samples/s, peak memory above the weights and inputs and device
    time by op (``device_split``); then the kernel alone at serve_bulk's
    shapes beside its byte bound, the plain version and
    ``F.embedding_bag``, and at serve_p99's item ids; its registers and
    spill bytes (0, a gate) and its lane plan against the C side's;
  * the model-train cell (``model_train_cell``): (a) gemma-7b at full
    width, GEMMA_TRAIN_LAYERS = 4 of 28 layers, bf16, through
    ``build_lm_train_step`` (adamw_nomaster, lr TRAIN_LR, n_micro 2) on 2
    x TRAIN_SEQ = 4,096 random tokens, GEMMA_TRAIN_STEPS = 4 steps on the
    repeated batch (a warm step, two timed, the last traced): the
    loss finite and falling, the first step's loss within 1e-2 of a
    no-grad ``lm_loss`` whose attention is the kernel (4 flash_attention
    launches), grad_norm at n_micro 1 and 2 within 1e-3, 0 launches in
    the steps, the last step traced by op; (b) mixtral-8x7b at full
    width, MIXTRAL_TRAIN_LAYERS = 2 of 32, under both routers: the loss
    falling, the peak under 75 GB, under k-choice one kchoice launch a
    layer a microbatch forward plus one a recompute, each recompute's
    assignment bit-equal to its forward's; (c) DLRM at MLPerf's widths
    (the five 40M-row tables cut to DLRM_TABLE_CAP = 2,000,000 rows) on
    ``criteo_stream`` at 65,536, xDeepFM at 16,384, BST at 65,536 and
    DIEN at 8,192 at their CONFIGs through ``build_ctr_train_step``, 3
    steps each, the loss falling; DIEN's steps launch no embedding_bag,
    its item table's first moment is nonzero on every history-only row,
    and the trained model serves with 2 launches; (d) SchNet at
    ``configs/schnet.CELL_SHAPES``: full_graph_sm (2,708 nodes padded to
    3,072), minibatch_lg (a fanout (15, 10) sample of 1,024 seeds over
    ``random_graph`` at reddit's 232,965 nodes with REDDIT_EDGES =
    11,648,250 edges, a mean degree of 50) and molecule (128 x 30
    atoms), 3 steps each; (e) one train step of each case of
    ``launch/step_cases`` (the reduced configs) on
    the card and on the CPU from the same state and batch, loss and
    every gradient leaf to PARITY_TOL = 1e-4; (f) ``launch/train.py`` for
    the seven model archs, 4 steps and a resume to 6, its final loss
    bit-equal to a straight 6-step run under
    ``torch.use_deterministic_algorithms(True)``. Each phase gives ms a
    step (CUDA events, after a warm step), tokens/s or samples/s, peak
    memory and its launches;
  * the registry and mesh cell (``registry_mesh_cell``, phase 18): (a)
    ``configs/registry.all_cells()`` logged (42 cells, skips), then on a
    world-size-1 NCCL DeviceMesh one call of each of these cells' own
    steps through ``get_arch(...).cells[...]``, bit-equal to the direct
    builder's output on the same inputs, its launches as counted:
    gemma-7b prefill_32k at REG_PREFILL = [1, 2048] (28 layers: 28
    flash_attention), DIEN serve_p99 (2 embedding_bag) and
    retrieval_cand (1 distance_topk), irli-deep1b serve_query over the
    cell's ``params(mesh)`` shapes with the corpus cut to L (irli_topk,
    freq_topc, quant_rerank) and train_scorers with R and the batch cut
    (no kernel; under deterministic algorithms); (b) gemma-7b's train_4k
    cell (MESH_TRAIN_LAYERS = 4 layers, batch MESH_TRAIN_BATCH x 4096)
    through ``cell.step(mesh)`` on DTensors placed by ``lm_rules`` and
    ``opt_state_specs``, two steps held to the meshless step (loss and
    grad_norm within 1e-5), both timed; (c) MESH_RANKS = 4 gloo ranks on
    the card, a (data 2, model 2) mesh (``mesh_rank``): gemma-like,
    qwen3-like with ``seq_shard_attn``, mixtral-like (8 TP experts, the
    k-choice router, the per-row dispatch: kchoice launches) and
    llama4-like (16 experts, EP, Adafactor) at MESH_D = 512, 4 layers,
    vocabulary 32,000, [8, 256] from ``ShardedLoader``: two steps, the
    loss and every gradient leaf within MESH_TOL of the meshless step,
    placements kept, one step's collective record, the kchoice launches
    of the mesh steps alone; ``compressed_psum`` int8 and top-k over
    "data": rank 0's sum held to the reference's formula over its data
    group's payloads, the error-feedback identity and the payload's
    bytes. The functional
    all-gather and all-to-all go through c10d's
    (``gloo_cuda_collectives``: torch 2.11's functional all-gather ends
    the process on CUDA tensors over gloo);
  * the dry run (phase 19, ``launch/dryrun.py``; the section's comment
    says what each part holds): (a) irli-deep1b serve_query and (c)
    dlrm-mlperf train_batch and retrieval_cand, DIEN serve_p99 and SchNet
    ogb_products on the fake 256-rank production mesh, with fake cuda
    tensors, (c)'s records equal to the CPU's; (a'), (b) and (d) the dry
    run's prediction of a call on a one-rank mesh held to the same call
    on the card (launches, argument bytes, FLOPs, peak memory): (a') the
    sharded search, (b) the model-train cell's gemma-7b step, (d) DIEN
    serve_p99, dlrm-mlperf retrieval_cand and train_batch and SchNet
    minibatch_lg on DTensors, each also held to its meshless call.

Each path's counters are set to 0 just before it runs and read just after;
the kernels line gives each kernel's launches by path.
Every search is held against the same search with the plain versions
(kernels/mega_query/ref.mega_search_ref), on the card: ids equal outside
the rows with a near tie (|a - b| <= 1e-5 + 1e-5·|b|) at the m, k' or k cut,
scores to 1e-5. The fit's kernels are held against their plain versions at
the fit's shapes (kchoice also on uniform candidate lists at the fit's
shape, at the stream's insert shape and at a worst case, every label of a
rep on one K-list: bit-equal, its rounds equal to the plain schedule's,
its bound from the inputs' dependence depth), and
the formerly refused shapes (irli_topk at m = 128, 40,000-wide freq_topc
rows through a cluster of two blocks, quant_rerank at topC = 20,000)
against theirs; freq_topc also on every row of tests/torch_freq_cases.py
(the card tests' widths and adversarial rows) and on 300,000-wide rows
(its wide kernel), with its registers and spill bytes (0, a gate) and its
launch plan against ops.radix_plan. bce_logits' gradient is held in the units
of σ(x) - y (each element divided by its row's scale·w), where TOL bounds
a value of size up to 1. Then it times every stage and kernel with CUDA
events; embedding_bag and quant_rerank (at tau = 2 and at tau = 1) also
by their device time alone (``device_ms``: calls captured in a CUDA graph),
beside their registers and spill bytes (0, a gate for both). The three
kernels on the fp32 tile GEMM (irli_topk.cuh: irli_topk,
mega_query, distance_topk) each get a tile line: TFLOP/s of their GEMM
operations and the share of the FMA peak, the card's own fp32 GEMM alone at
the same shapes beside it (torch.bmm, torch.mm; no TF32), the ring's depth
and slice depth, registers and spill bytes (0 spill bytes is a gate for
irli_topk, both its variants, and distance_topk, dot and l2); mega_query's
phases are timed apart by probe launches (the last phase run, and phase 2's
GEMM walked without its selection), which give the share of phase 2 that
its epilogue takes.

Its last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record (launches, error, times, bounds). Any failure raises
and exits non-zero with no ``ok`` line; so does a run without a card, or
from a directory that holds this file and nothing else of the repository.
``python3 chip_smoke.py --fit-recall L N`` runs only the fit cell's fit and
recall, at L labels and N training queries, and prints them as JSON;
``--distributed`` runs only the build, the search cell's index and the
distributed cell; ``--audit`` the build, that index and the audit cell;
``--train`` the build and the train cell; ``--lm`` the build, the LM
cell and the MoE cell; ``--model-train`` the build and the model-train
cell; ``--mesh`` the build and the registry and mesh cell; ``--dryrun``
the build, the search cell's index and phase 19.

Widths (configs/irli_deep1b.py): D=96, B=20000, R=32, H=1024. Search, the
serve_query cell: int8 block 32, m=5, tau=2, k=10, topC=1024, refine_k auto
(40); reduced in scale to one card: L = 2,000,000 corpus rows (of 2^27),
so that max_load = 2·L/B = 200 and the gathered width C0 = R·m·max_load =
32,000 fits one freq_topc block and mega_query's sort (MAX_WIDTH 32,768);
Q = 1024 queries per call (of 4096); data, queries and weights random,
from a seed. The stream cell: the same index and queries, K = 10 placement
choices, the reference's default capacity 2·L and delta_len 208
(default_delta_len); its streaming search gathers C0 = R·m·(200 + 208) =
65,280 ids a query (a cluster of two freq_topc blocks; 55,040 after
compaction); its 65,536 inserts and
100,000 deletes are 3.3% and 5% of the corpus. The fit: K =
FIT_K = 10, 100 exact-neighbour labels a point (K_NEIGH), lr 1e-3, ANN mode
(Def. 2); reduced in scale: L = N = 131,072 labels and training points (of
2^27; each base vector a training query labelled with its 100 exact
neighbours, computed on the card), batch 4096 (of FIT_BATCH 32,768, whose
targets alone would be 84 GB), 2 rounds (of 5) of 1 epoch (of 5), affinity
chunk FIT_AFFINITY_CHUNK = 65,536; data by clustered_ann's recipe at these
sizes from SEED. The softmax_bce fit: one round over N = L = 16,384 at
batch 1024 (its autograd keeps several [R, batch, B] tensors). More labels
a bucket do not lift the fit's recall on this data: at L = 2,000,000 and
N = 131,072 (``--fit-recall 2000000 131072``) the partition collapses
alike, so the cell keeps L/B = 6.55 and its time (PERF.md). The LM cell:
the reference's ``prefill_32k`` cell (configs/lm_common.py: batch 32 x
32,768 over a pod) cut to one card as two request shapes, [1, 32768] (the
cell's prompt length, batch 1) and [4, 2048] (a few short requests);
tokens random from SEED; qwen3-4b's depth cut to 4 layers. gemma-7b's
decode: the reference's decode cells cut to B = 8 at a 4,096-token
context (a 15 GB cache beside 17.1 GB of weights). The MoE cell:
mixtral-8x7b's depth cut from 32 to 4 layers (46.7 B parameters, 93 GB in
bf16, do not fit one card); llama4-maverick's block alone (one period of
its 4 layers is about 130 GB: the whole model waits for four cards). The
baselines: balanced k-means cut to 8,192 labels (its walk is a host loop).
The recsys
cell: the reference's serve_p99 and serve_bulk cells
(configs/recsys_common.py) for DIEN, at full width and batch, on one card
in place of a mesh. The distributed cell: the serve_query cell's own
production search (``build_irli_serve``, every chip a corpus shard) at
world size 1 over its whole index, and cut from the reference's mesh to 4
ranks on one card over quarters of that corpus (the card's one NVLink
peer is itself: collectives across chips wait for a four-chip cell); the
mesh fit at 32,768 labels, one round (1 x 1), and at narrow widths (2 x
2: gloo would move a 1.3 GB w2 gradient a step at full width). Depth cut
to keep the whole run under 460 s with the train cell: the server cell's
burst from 4,096 to N_BURST = 1,024 requests (2,048 until the train cell
came), the first N_BARE = 512 of them without the probe counter (its
rate is the same at any count; its p50/p99 grow with it); with the
decode, vocabulary-head and MoE phases, the paced run from 512 to N_PACED
= 256 requests and the mutation phase from 4,096 to N_MUT_Q = 2,048
queries (an insert every MUT_EVERY = 512 of them, was 1,024: four
inserts and the delete after the second, as before). The train
cell: the fit cell's config with R cut from 32 to TRAIN_R = 2 (R counts
independent repetitions, the fit's depth: a round then takes about 1 s
and a checkpoint, w2 and its two AdamW moments, about 0.5 GB, where R =
32 takes 16 s and 7.9 GB; R was 4 until the model-train cell came), 3
rounds of 1 epoch (of 5 and 5); (b) at the narrow widths above, 8,192
labels. To fit the model-train cell, the refit cell's R was cut from 32
to REFIT_R = 16 (its artifact's verify, save and restore took 36 of its
52 s at R = 32; at R = 8 only 97.3% of the tail inserts found
themselves, under the 99% gate) and kchoice's uniform-list check at the
fit's 32 reps from 131,072 labels to UNIFORM_L = 32,768 (its plain walk
and window schedule run on the host, label by label); the reddit-sized
graph of the model-train cell is built in a spawned host process while
the card runs the cell's (a) and (b). The model-train cell: gemma-7b's
depth cut to 4 layers and mixtral-8x7b's to 2 (the state of the whole
models, 137 GB and more, does not fit one card), the global batch of
train_4k's cell (256) to 2, DLRM's five 40M-row tables to 2,000,000 rows
(the full 104.5 GB table holds no state), reddit's degree from ~492 to
50 (the host's build time), ogb_products left out (its RBF expansion
alone is 74 GB). The registry and mesh cell: the prefill_32k cell's [32,
32768] to [1, 2048], serve_query's corpus from 2^27 rows to L (its
members at max_load 200, as the search cell's), train_scorers' R from
32 to 4, its batch from 32,768 to 4,096 and its corpus to L; train_4k's
depth and batch as the model-train cell's; (c) at narrow widths, one
microbatch a step and a sequence of 256 (of 512), to keep the phase under
60 s (85.5 s at 512 with the vocabulary gathered for the loss, on an
H100 80GB HBM3 at 700 W). Phase 19 (d): dlrm-mlperf train_batch's five
40M-row tables cut to DLRM_TABLE_CAP rows as the model-train cell cuts
them (its whole table, 104.5 GB, holds no state on one card).
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.configs.irli_deep1b import (  # noqa: E402
    B_BUCKETS as B, D, FIT_AFFINITY_CHUNK, FIT_K, HIDDEN as H, K_NEIGH, R,
    STORE_BLOCK as BLOCK)

SEED = 0
L = 2_000_000
Q = 1024
Q_SMALL = 64
M, TAU, K, TOPC = 5, 2, 10, 1024
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989.4e12              # H100 SXM bf16 dense, tensor cores
TOL = 1e-5                         # |a - b| <= TOL + TOL·|b| for fp32 values
KERNELS = ("irli_topk", "freq_topc", "quant_rerank", "mega_query",
           "bce_logits", "kchoice", "distance_topk", "flash_attention",
           "embedding_bag")
# the stream cell
N_INSERT, INSERT_BATCH, N_DEL_BASE, N_DEL_NEW = 65_536, 4096, 90_000, 10_000
DELTA_LEN = 208                    # default_delta_len(2·L, L, B)
# the fit cell
FIT_L = 131_072
UNIFORM_L = 32_768               # kchoice's uniform-list check: labels
FIT_BATCH, FIT_ROUNDS, FIT_CHUNK = 4096, 2, FIT_AFFINITY_CHUNK
# a neighbours chunk (1024 queries, k = K_NEIGH, over FIT_L rows) may take no
# longer than it did before the tile GEMM's redesign: 7.4278 ms on an H100
# 80GB HBM3 at 700 W (PERF.md)
NEIGHBOURS_MS_MAX = 7.4278
SOFT_L, SOFT_BATCH = 16_384, 1024
# the server cell: requests of the burst, of the burst without the probe
# counter, of the paced run, one in eight at m = WIDE_M (a batch then holds
# about 7 requests, and a batch of 8 rows takes about as long as one of
# 1024: these counts keep the script's time, and the rates are the same at
# any count); the mutation phase's queries, an insert of MUT_INSERT rows
# after every MUT_EVERY queries and a delete of N_MUT_DEL live ids after the
# second insert
N_BURST, N_BARE, N_PACED, WIDE_M = 1024, 512, 256, 10
N_MUT_Q, MUT_EVERY, MUT_INSERT, N_MUT_DEL = 2048, 512, 4096, 10_000
# the refit cell (over FIT_L labels): queries served, rows inserted before
# the cycle and again while it runs (the swap's tail), ids deleted
N_REFIT_Q, REFIT_INSERT, REFIT_DELETE = 4096, 4096, 1000
REFIT_MIN_Q, REFIT_HOT = 1024, 0.005     # RefitConfig's min_queries, hot_frac
REFIT_R = 16                             # of R = 32, for the run's time
# the distributed cell: (b) P = DIST_P gloo ranks on the card, each over
# DIST_L = L / DIST_P rows of the search cell's corpus; (c) the 1 x 1 mesh
# fit at deep1b widths over DIST_FIT_L labels (one round), and the 2 x 2
# mesh fit across 4 gloo ranks at narrow widths over NARROW_L labels
DIST_P = 4
DIST_L = L // DIST_P
DIST_FIT_L = 32_768
NARROW_L, NARROW = 8192, dict(n_buckets=2000, n_reps=4, d_hidden=256)
# the LM cell: [batch, prompt length] of each gemma-7b prefill
LM_SHAPES = ((4, 2048), (1, 32768))
QWEN_LAYERS = 4
# the last hidden state's relative L2 error of a prefill against the same
# prefill with the plain attention: two bf16 attentions that round P apart
# differ by 2.4e-2 to 2.5e-2 after gemma-7b's 28 random layers (PERF.md)
PREFILL_TOL = 5e-2
# decode: batch rows, gemma-7b's context, teacher-forced steps, the timed
# step's position; a decode step's logits against the teacher-forced
# forward's, relative L2 (the prefill's limit: bf16 rounding apart)
DECODE_B, DECODE_CTX, DECODE_STEPS, DECODE_POS = 8, 4096, 16, 4064
DECODE_TOL = 5e-2
# the IRLI vocabulary head over gemma-7b's vocabulary: buckets, reps,
# scorer width, probes
HEAD_B, HEAD_R, HEAD_H, HEAD_M = 4096, 4, 1024, 8
# the MoE cell: mixtral-8x7b's layers kept, the prefill's length, the
# position its decode starts at (its 16 steps cross 4096: the ring wraps)
MOE_LAYERS, MOE_SEQ, MOE_POS = 4, 8192, 4088
# the per-row path's tokens a row (2 rows, ffn_chunk = MOE_ROWS_T), and the
# tokens of llama4-maverick's MoE block
MOE_ROWS_T, LLAMA4_T = 4096, 2048
# balanced k-means' labels and buckets (its walk runs on the host)
BALANCED_L, BALANCED_B = 8192, 64


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n: int = 15, warmup: int = 3) -> float:
    """Median of n CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, n: int = 20) -> float:
    """The device time of one fn() call in ms without the host time of
    the call, which time_ms includes: n calls captured in one CUDA graph,
    the median of 5 replays over n."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(torch, graph.replay, n=5, warmup=1) / n


def bound(flops: float, nbytes: float):
    """The least time the card could take: the larger of the operations at
    the fp32 peak and the bytes at the memory rate -> (ms, bound_by)."""
    return max((flops / FP32_FLOPS * 1e3, "operations"),
               (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))


def freq_smem_bytes(plan: dict, rows: int, windows: int) -> int:
    """Shared-memory bytes freq_topc's row kernel moves for `rows` rows of
    its plan (ops.radix_plan) and `windows` count windows in all: a radix
    pass takes a 4-byte atomic on the key's counter in each of its two
    walks, writes the key to its rank and reads it back (16 B a slot), a
    window the two atomics (8 B a slot); each scans the block's counters
    (read twice, written once); the run count reads each slot's neighbour
    (4 B a slot)."""
    slots = min(plan["slots"], plan["threads"] * 64)      # a block's
    words = plan["threads"] * 34                           # its counters
    blocks = rows * plan["cluster"]
    return (blocks * (plan["passes"] * (16 * slots + 12 * words)
                      + 4 * slots)
            + windows * plan["cluster"] * (8 * slots + 12 * words))


def tile_report(name, ms, flops, alone_ms, alone, attrs,
                spill_gate=True) -> dict:
    """The tile GEMM's account of one kernel (irli_topk.cuh's ring and
    slices): the TFLOP/s of its GEMM operations and their share of the FMA
    peak, the card's own fp32 GEMM alone at the same shapes (``alone``, no
    TF32) beside it, the ring's depth and slice depth, registers and spill
    bytes a thread (0 a gate, unless spill_gate is False: mega_query's
    cooperative kernel, whose phase code shares 128 registers a thread,
    spilled before the tile was redesigned). -> the kernels line's extra
    keys."""
    rate, alone_rate = flops / ms / 1e9, flops / alone_ms / 1e9
    log(f"{name} tile: {flops / 1e12:.4f} TFLOP of GEMM in {ms:.4f} ms = "
        f"{rate:.1f} TFLOP/s, {100 * rate / (FP32_FLOPS / 1e12):.1f}% of the "
        f"{FP32_FLOPS / 1e12:.0f} TFLOP/s FMA peak; the fp32 GEMM alone "
        f"({alone}) {alone_ms:.4f} ms = {alone_rate:.1f} TFLOP/s, "
        f"{100 * alone_rate / (FP32_FLOPS / 1e12):.1f}%; ring "
        f"{attrs['stages']} stages of {attrs['slice_depth']}-deep slices; "
        f"{attrs['registers']} registers, {attrs['spill_bytes']} spill bytes "
        f"a thread")
    if spill_gate and attrs["spill_bytes"] != 0:
        raise AssertionError(f"{name} spills registers: {attrs}")
    return {"tflops": rate, "fma_share": rate / (FP32_FLOPS / 1e12),
            "gemm_alone_ms": alone_ms, "spill_bytes": attrs["spill_bytes"]}


def bce_grad_err(gk, gp, wt, scale, rows=8192) -> float:
    """max |gk - gp| / (scale·w[row mod N]) over the rows of two [R·N, B]
    bce_logits gradients whose rows carry weight w [N] -- the error of
    σ(x) - y itself -- taken 8192 rows at a time; raises unless a
    zero-weight row's gradient is exactly 0 in both."""
    import torch
    N = wt.shape[0]
    err = 0.0
    for s in range(0, gk.shape[0], rows):
        n = min(rows, gk.shape[0] - s)
        w = wt[(s + torch.arange(n, device=gk.device)) % N]
        d = (gk[s:s + rows] - gp[s:s + rows]).abs()
        if bool((gk[s:s + rows][w == 0] != 0).any()
                or (gp[s:s + rows][w == 0] != 0).any()):
            raise AssertionError("bce_logits: a zero-weight row has a "
                                 "gradient")
        live = w > 0
        if bool(live.any()):
            err = max(err, float((d[live] / (scale * w[live, None])).max()))
    return err


def serve_data(torch, dev):
    """The search cell's corpus [L, D] (unit rows) and Q queries (noisy
    copies of corpus rows, unit), from SEED on the card."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    corpus = torch.randn((L, D), generator=gen, device=dev)
    corpus /= corpus.norm(dim=1, keepdim=True)
    src = torch.randint(0, L, (Q,), generator=gen, device=dev)
    queries = corpus[src] + 0.05 * torch.randn((Q, D), generator=gen,
                                               device=dev)
    queries /= queries.norm(dim=1, keepdim=True)
    return corpus, queries


def neighbours(torch, dev, base, q, k):
    """Exact top-k ids of q in base on the card (core/query.exact_topk: one
    distance_topk launch), 1024 queries at a time."""
    from repro_torch.core.query import exact_topk
    tomb = torch.zeros(base.shape[0], dtype=torch.bool, device=dev)
    return torch.cat([exact_topk(q[s:s + 1024], base, tomb, k=k)
                      for s in range(0, q.shape[0], 1024)])


def fit_config(n_labels: int, **over):
    """The fit cell's IRLIConfig at n_labels labels (sigmoid_bce, ANN mode,
    FIT_ROUNDS rounds of 1 epoch at batch FIT_BATCH), with overrides."""
    from repro_torch.core.index import IRLIConfig
    kw = dict(d=D, n_labels=n_labels, n_buckets=B, n_reps=R, d_hidden=H,
              K=FIT_K, rounds=FIT_ROUNDS, epochs_per_round=1,
              batch_size=FIT_BATCH, lr=1e-3, loss="sigmoid_bce",
              affinity_chunk=FIT_CHUNK, seed=SEED)
    return IRLIConfig(**{**kw, **over})


def fit_run(torch, dev, n_labels: int, n_train: int) -> dict:
    """The fit cell's data, its fit through IRLIIndex.fit and recall@K of Q
    held-out queries before the fit (the hash partition) and after it.
    n_train == n_labels is the paper's ANN mode, every base vector a
    training query; fewer train on clustered_ann's held-apart training
    queries. Each is labelled with its K_NEIGH exact neighbours, computed on
    the card. Checks the launches (bce_logits a train step, irli_topk an
    affinity chunk, kchoice a round), that round 2's loss is below round
    1's and that the fit's recall is above the hash partition's."""
    from repro_torch.core.index import IRLIIndex
    from repro_torch.core.search_api import SearchParams
    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.fit.engine import FitEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.store.quantized import encode

    t0 = time.perf_counter()
    paper = n_train == n_labels
    base, fq, tq = clustered_vectors(
        n_base=n_labels, n_queries=Q, n_train=None if paper else n_train,
        d=D, seed=SEED)
    base, fq = torch.from_numpy(base).to(dev), torch.from_numpy(fq).to(dev)
    train = base if paper else torch.from_numpy(tq).to(dev)
    labels = neighbours(torch, dev, base, train, K_NEIGH)      # [N, 100]
    gt = neighbours(torch, dev, base, fq, K)                    # [Q, 10]
    store = encode(base, "int8", BLOCK)
    torch.cuda.synchronize()
    log(f"fit data: clustered_ann's recipe, {n_labels} x {D} base (the "
        f"labels), {n_train} training queries "
        f"({'the base itself' if paper else 'near base vectors'}) with "
        f"{K_NEIGH} exact neighbours each, and the {Q} held-out queries' "
        f"top-{K}, on the card: {time.perf_counter() - t0:.2f} s")

    cfg = fit_config(n_labels)
    idx = IRLIIndex(cfg, device=dev)
    sp = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8")

    def recall():
        """recall@K of the held-out queries, the search's mode, and the
        share of (rep, label) slots the index holds: build_index keeps at
        most max_load = 2·L/B labels a bucket."""
        idx.build_index()
        res = idx.search(fq, store, sp)
        hit = ((res.ids[:, :, None] == gt[:, None, :])
               & (res.ids[:, :, None] >= 0)).any(-1).sum(1)
        kept = float((idx.index.members >= 0).sum()) / (R * n_labels)
        return float(hit.float().mean()) / K, res.mode, kept

    r_hash, mode, k_hash = recall()
    rows, round0 = [], {}

    class RoundLog:
        def log(self, row, step):
            rows.append(row)
            if step == 0:                      # round 1's outcome, kept
                round0.update(row, assign=idx.assign.clone())

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    stats = idx.fit(train, labels, label_vecs=base, log=RoundLog())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: c for n, c in LAUNCHES.items() if c}
    eng = FitEngine(cfg, idx.scorer_cfg)
    n_rounds = len(stats.round_idx)
    steps = eng.batch_plan(n_train)[0]
    want = {"bce_logits": steps * n_rounds,
            "irli_topk": -(-n_labels // FIT_CHUNK) * n_rounds,
            "kchoice": n_rounds}
    for row in rows:
        log(f"fit round {row['round']}: {row['seconds']:.3f} s, loss "
            f"{row['loss']:.6f}, reassigned {row['n_reassigned']} (churn "
            f"{row['churn']:.4f}), load std {row['load_std']:.4f}, min "
            f"{row['load_min']:.0f}, max {row['load_max']:.0f}, KL "
            f"{row['load_kl']:.5f}, grad norm {row['grad_norm']:.5f}")
    log(f"fit: {n_rounds} rounds of {steps} steps in {fit_s:.2f} s; "
        f"launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"the fit launched {launches}, expected {want}")
    if n_rounds < 2 or not stats.train_loss[1] < stats.train_loss[0]:
        raise AssertionError(f"round 2's loss is not below round 1's: "
                             f"{stats.train_loss}")
    r_fit, mode, k_fit = recall()
    log(f"recall@{K} of {Q} held-out queries (IRLIIndex.search, mode='auto' "
        f"-> {mode!r}, m={M}, tau={TAU}, topC={TOPC}, int8 store) against "
        f"exact_topk: hash partition {r_hash:.4f}, after the fit "
        f"{r_fit:.4f}; (rep, label) slots in the index (max_load "
        f"{idx.index.members.shape[2]}): hash {k_hash:.4f}, fit {k_fit:.4f}")
    if not r_fit > r_hash:
        raise AssertionError(f"the fitted index's recall {r_fit} is not above "
                             f"the hash partition's {r_hash}")
    return dict(idx=idx, eng=eng, cfg=cfg, base=base, train=train,
                labels=labels, rows=rows, round0=round0, launches=launches,
                recall=(r_hash, r_fit), queries=fq, gt=gt)


@contextlib.contextmanager
def plain_versions():
    """Route the fit's three kernel dispatch sites to their plain versions
    while the block runs, on the card too: bce_logits' forward
    (kernels/bce_logits/ops.weighted_bce), the affinity's output layer and
    top-K (fit/affinity.scorer_topk) and the re-assignment
    (core/repartition.kchoice_assign). Only for the comparison of a whole
    round with its kernel-free twin."""
    import repro_torch.core.repartition as rp
    import repro_torch.fit.affinity as aff
    from repro_torch.kernels.bce_logits import ops as bops
    from repro_torch.kernels.bce_logits.ref import weighted_bce_ref
    from repro_torch.kernels.irli_topk.ref import irli_topk_ref
    from repro_torch.kernels.kchoice.ref import kchoice_ref
    saved = bops.weighted_bce, aff.scorer_topk, rp.kchoice_assign
    bops.weighted_bce = (lambda x, y, w=None, *, scale=1.0:
                         weighted_bce_ref(x, y, w, scale))
    aff.scorer_topk, rp.kchoice_assign = irli_topk_ref, kchoice_ref
    try:
        yield
    finally:
        bops.weighted_bce, aff.scorer_topk, rp.kchoice_assign = saved


def plain_round_check(torch, dev, run: dict) -> float:
    """Round 1 of the fit again, from the same start (the weights, batches
    and insertion orders all come from cfg.seed), with the plain versions in
    place of the three kernels and no launch; held against the kernel fit's
    round 1: its mean loss to 1e-4 relative (the tolerance of
    tests/test_torch_fit.py for a round against the reference), its load
    std to 1%, and the assignment equal in at least 95% of the (rep, label)
    slots. The rest may rightly differ: two of a label's top-K buckets whose
    logits are a near tie (the sums run in another order) swap places, and
    where both hold the least load at the label's turn the walk takes the
    first, so the label goes elsewhere and the walk carries that on. A wrong
    kernel moves far more. The plain affinity holds one [R, chunk, B] logit
    block, so it runs at chunk 2048. -> the share of slots assigned
    alike."""
    from repro_torch.core.index import IRLIIndex
    from repro_torch.kernels import LAUNCHES, reset_launches
    n_labels = run["base"].shape[0]
    pidx = IRLIIndex(fit_config(n_labels, rounds=1, affinity_chunk=2048),
                     device=dev)
    rows = []

    class RoundLog:
        def log(self, row, step):
            rows.append(row)

    reset_launches()
    t0 = time.perf_counter()
    with plain_versions():
        pidx.fit(run["train"], run["labels"], label_vecs=run["base"],
                 log=RoundLog())
    torch.cuda.synchronize()
    k0, p0 = run["round0"], rows[0]
    same = float((pidx.assign == k0["assign"]).float().mean())
    loss_rel = abs(p0["loss"] - k0["loss"]) / abs(k0["loss"])
    std_rel = abs(p0["load_std"] - k0["load_std"]) / k0["load_std"]
    log(f"fit round 1 with the plain versions (no launch: "
        f"{sum(LAUNCHES.values())} launches), {time.perf_counter() - t0:.1f}"
        f" s: loss {p0['loss']:.6f} (kernels {k0['loss']:.6f}, relative "
        f"{loss_rel:.3g}), load std {p0['load_std']:.4f} (kernels "
        f"{k0['load_std']:.4f}), assignment equal in {same:.6f} of the "
        f"(rep, label) slots")
    if sum(LAUNCHES.values()) or not (loss_rel <= 1e-4 and std_rel <= 0.01
                                      and same >= 0.95):
        raise AssertionError("the fit's round 1 through the kernels differs "
                             "from its plain twin")
    del pidx
    return same


def dense_check(torch, dev, idx, base, q) -> float:
    """Dense mode over the fitted index (fp32 corpus, L = FIT_L): one
    irli_topk and one distance_topk launch, no other kernel, held against
    the plain dense search (stable top-m of the logits, the [Q, L] count
    table, distance_topk_ref): ids and n_candidates equal outside the rows
    with a near tie at the m or k cut, scores to TOL. -> (max |err|, the
    search's launches)."""
    from repro_torch.core.network import scorer_logits
    from repro_torch.core.query import (candidate_frequencies_dense,
                                        gather_members)
    from repro_torch.core.search_api import SearchParams
    from repro_torch.core.topk import topk_stable
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.kernels.irli_topk.ref import near
    dense = SearchParams(m=M, tau=TAU, k=K, mode="dense")
    torch.cuda.synchronize()
    reset_launches()
    res = idx.search(q, base, dense)
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    if launches != {"irli_topk": 1, "distance_topk": 1} or res.mode != \
            "dense":
        raise AssertionError(f"the dense search launched {launches}")
    logits = scorer_logits(idx.params, q)
    vals, bidx = topk_stable(logits, M + 1)
    del logits
    mcut = near(vals[..., M - 1], vals[..., M], TOL).any(dim=0)
    cands = gather_members(idx.index.members, bidx[..., :M])
    mask = candidate_frequencies_dense(cands, base.shape[0]) >= TAU
    pv, pi = distance_topk_ref(q, base, mask, k=K + 1)
    pi = torch.where(torch.isfinite(pv), pi, torch.full_like(pi, -1))
    kcut = torch.isfinite(pv[:, K]) & near(pv[:, K - 1], pv[:, K], TOL)
    ok = ~(mcut | kcut)
    nc = mask.sum(dim=1, dtype=torch.int32)
    fin = torch.isfinite(pv[:, :K])
    close = torch.where(fin, near(res.scores, pv[:, :K], TOL),
                        res.scores == pv[:, :K]).all(dim=1)
    same = (res.ids == pi[:, :K]).all(dim=1) & close & (res.n_candidates
                                                          == nc)
    if bool((ok & ~same).any()):
        raise AssertionError(f"dense search: {int((ok & ~same).sum())} rows "
                             f"differ from the plain dense search")
    err = float((res.scores - pv[:, :K])[ok[:, None] & fin].abs().max())
    ms = time_ms(torch, lambda: idx.search(q, base, dense), n=5)
    log(f"dense search (mode='dense', fp32, L={base.shape[0]}, Q={len(q)}; "
        f"launches {launches}): ids and n_candidates equal to the plain "
        f"dense search ({int((~ok).sum())} near-tie rows exempt), max |err| "
        f"{err:.3g}; survivors/query mean {float(nc.float().mean()):.1f}; "
        f"{ms:.4f} ms")
    return err, launches


def kchoice_check(torch, name, ids, orders, load0, weights, link, sm_clock,
                  n: int = 10, worst: bool = False):
    """kchoice on [G, L, K] candidates: bit-equal to the plain loop
    (kchoice_ref), its rounds (windows and in-register steps) equal to the
    plain schedule's (kchoice_windows), two launches equal; its time beside
    the bound of what these inputs need: the larger of the bytes
    (candidates, order, assignment, starting loads and weights once) at the
    memory rate and the longest dependence chain (dependence_depth) of
    links of `link` clocks each (the cheapest the card chains: a min and an
    add in registers) at the SM clock. Returns (ms, plain ms, (bound ms,
    bound_by))."""
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.kchoice.ref import (dependence_depth,
                                                 kchoice_ref,
                                                 kchoice_windows)
    G, n_lab, k = ids.shape
    got = kops.kchoice(ids, orders, load0, weights, B=B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = kchoice_ref(ids, orders, load0, weights, B=B)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, want):
        raise AssertionError(f"kchoice differs from the plain loop at {name} "
                             f"in {int((got != want).sum())} placements")
    rounds = torch.zeros(G, dtype=torch.int32, device=ids.device)
    again = kops.kchoice(ids, orders, load0, weights, B=B, rounds=rounds)
    plain, plain_rounds = kchoice_windows(ids, orders, load0, weights, B=B)
    if not (torch.equal(again, got) and torch.equal(plain, want)):
        raise AssertionError(f"kchoice at {name}: a second launch or the "
                             f"plain window schedule differs")
    if rounds.tolist() != plain_rounds.tolist():
        raise AssertionError(f"kchoice at {name}: rounds {rounds.tolist()}, "
                             f"the plain schedule's {plain_rounds.tolist()}")
    depth = dependence_depth(ids, orders, got, B=B)
    if worst and depth.tolist() != [n_lab] * G:
        raise AssertionError(f"kchoice's worst case: dependence depth "
                             f"{depth.tolist()}, not {n_lab} each")
    ms = time_ms(torch, lambda: kops.kchoice(ids, orders, load0, weights,
                                             B=B), n=n)
    nbytes = (G * n_lab * (k + 2) * 4
              + (0 if load0 is None else load0.numel() * 4)
              + (0 if weights is None else weights.numel() * 4))
    chain = int(depth.max()) * link / sm_clock * 1e3
    k_bound = max((chain, "operations"),
                  (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    n_rnd = rounds.double()
    log(f"kchoice {list(ids.shape)} at {name}: bit-equal to the plain loop, "
        f"two launches equal, rounds a rep {int(n_rnd.min())}-"
        f"{int(n_rnd.max())} (mean {float(n_rnd.mean()):.1f}, equal to the "
        f"plain schedule's), {n_lab / float(n_rnd.mean()):.2f} labels a "
        f"round, dependence depth {int(depth.min())}-{int(depth.max())}; "
        f"kernel {ms:.4f} ms ({ms * 1e-3 * sm_clock / float(n_rnd.mean()):.1f}"
        f" clocks a round, {ms * 1e-3 * sm_clock / n_lab:.1f} a label), "
        f"plain (host loop) {plain_ms:.1f} ms; bound {k_bound[0]:.5f} ms "
        f"({k_bound[1]}: {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms; depth {int(depth.max())} "
        f"x {link:.2f} clocks = {chain:.5f} ms), {k_bound[0] / ms:.2%} of "
        f"it")
    return ms, plain_ms, k_bound


def uniform_lists(torch, G: int, L: int, K: int, seed: int):
    """[G, L, K] int32: K distinct bucket ids < B a label, uniform, as a
    balanced partition's candidate lists are; the lists that repeat an id
    are drawn again. On the host, from the seed."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(B, (G * L, K), generator=gen)
    while True:
        srt = ids.sort(1).values
        again = (srt[:, 1:] == srt[:, :-1]).any(1).nonzero()[:, 0]
        if len(again) == 0:
            return ids.view(G, L, K).int()
        ids[again] = torch.randint(B, (len(again), K), generator=gen)


def fit_cell(torch, dev, check_irli) -> dict:
    """The fit cell: IRLIIndex.fit at the irli-deep1b widths (sigmoid_bce,
    ANN mode, fit_run), its kernels against their plain versions at the
    fit's shapes, its round 1 against a kernel-free twin, the stage times;
    then one round of a softmax_bce fit. Returns the kernels' launches on
    the fit's path, their records, times and bounds."""
    import torch.nn.functional as F

    from repro_torch.core import partition as PT
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import (scorer_hidden, scorer_logits,
                                          scorer_loss_parts)
    from repro_torch.core.repartition import insertion_orders
    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.fit.engine import FitData
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.bce_logits import ops as bops
    from repro_torch.kernels.bce_logits.ref import weighted_bce_ref
    from repro_torch.kernels.distance_topk import ops as dops
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.optim.optimizers import apply_clip, global_norm_sq

    run = fit_run(torch, dev, FIT_L, FIT_L)
    idx, eng = run.pop("idx"), run["eng"]
    baselines = baselines_phase(torch, dev, run, idx)
    base, train, labels = run["base"], run["train"], run["labels"]
    rows, launches = run["rows"], run["launches"]
    build_ms = time_ms(torch, idx.build_index, n=5)
    dist_err, dense_launches = dense_check(torch, dev, idx, base,
                                           run.pop("queries"))
    q1 = train[:1024]
    every = torch.ones((1, FIT_L), dtype=torch.bool, device=dev)
    vals, ids = dops.distance_topk(q1, base, every.expand(1024, -1),
                                   k=K_NEIGH)
    if not torch.equal(neighbours(torch, dev, base, q1, K_NEIGH), ids):
        raise AssertionError("neighbours differs from its distance_topk "
                             "launch")
    dist_err = max(dist_err, dist_check(
        torch, "neighbours' chunk", vals, ids, q1, base, every, K_NEIGH))
    nb_ms = time_ms(torch, lambda: neighbours(torch, dev, base, q1, K_NEIGH),
                    n=3, warmup=1)
    allq = every.expand(1024, -1)
    nb_plain = time_ms(torch, lambda: distance_topk_ref(q1, base, allq,
                                                        k=K_NEIGH),
                       n=3, warmup=1)

    def nb_library():
        sim = torch.matmul(q1, base.T)
        sim.masked_fill_(~every, -torch.inf)
        return torch.topk(sim, K_NEIGH, dim=1)

    nb_lib = time_ms(torch, nb_library, n=3, warmup=1)
    # its bound: the distances' operations, and the rows, queries, the
    # stride-0 mask and the k ids and values each moved once
    nb_cost = dops.cost(1024, FIT_L, D, K_NEIGH)
    nb_bound = bound(nb_cost["flops"], nb_cost["bytes"])
    log(f"neighbours (exact_topk, k={K_NEIGH}) of one chunk of 1024 "
        f"training queries over {FIT_L} rows: {nb_ms:.4f} ms (at most "
        f"{NEIGHBOURS_MS_MAX}); bound {nb_bound[0]:.4f} ms ({nb_bound[1]}: "
        f"{2 * 1024 * FIT_L * D / 1e9:.2f} GFLOP at the fp32 peak); plain "
        f"{nb_plain:.4f} ms, library (torch.matmul + masked_fill_ + "
        f"torch.topk) {nb_lib:.4f} ms")
    if nb_ms > NEIGHBOURS_MS_MAX:
        raise AssertionError(f"a neighbours chunk took {nb_ms:.4f} ms, more "
                             f"than {NEIGHBOURS_MS_MAX}")
    del vals, ids

    # ---- one train step: bce_logits against the plain loss, and fp64 ----
    params, keys = idx.params, sorted(idx.params)
    idx_b, w_b = eng.round_batches(FIT_L, SEED, 0)
    ones = torch.ones((FIT_BATCH, K_NEIGH), device=dev)

    def step_grads(n, plain=False, dtype=torch.float32):
        sel, wt = idx_b[0, :n].to(dev), w_b[0, :n].to(dev)
        tg = PT.bucket_targets(idx.assign, labels[sel], ones[:n], B)
        p = {k: v.detach().to(dtype).requires_grad_(True)
             for k, v in params.items()}
        scale = 1.0 / (R * max(float(wt.sum()), 1.0))
        x, tg, wt = train[sel].to(dtype), tg.to(dtype), wt.to(dtype)
        if plain:
            lg = scorer_logits(p, x)
            per = lg.clamp_min(0) - lg * tg + torch.log1p(torch.exp(-lg.abs()))
            s = (per.sum(-1) * wt).sum() * scale
        else:
            s, _ = scorer_loss_parts(p, idx.scorer_cfg, x, tg, wt,
                                     scale=scale)
        g = torch.autograd.grad(s, [p[k] for k in keys])
        return s.detach(), dict(zip(keys, g))

    sk, gk = step_grads(512)
    sp_, gp = step_grads(512, plain=True)
    s64, g64 = step_grads(512, plain=True, dtype=torch.float64)
    if abs(float(sk) - float(sp_)) > 1e-5 * abs(float(sp_)):
        raise AssertionError(f"train step loss: kernel {float(sk)}, plain "
                             f"{float(sp_)}")
    rel = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max())
           for k in keys}
    rel64 = {k: float((gk[k].double() - g64[k]).abs().max()
                      / g64[k].abs().max()) for k in keys}
    log(f"one train step (512 rows): loss kernel {float(sk):.8f}, plain "
        f"{float(sp_):.8f}, fp64 {float(s64):.8f}; gradients kernel vs plain "
        f"max |err| / max |g|: {rel}; fp32 kernel vs fp64: {rel64}")
    if max(rel.values()) > 1e-5:
        raise AssertionError(f"train step gradients off the plain ones: {rel}")
    if max(rel64.values()) > 1e-4:
        raise AssertionError(f"train step gradients off fp64 by {rel64}: "
                             f"are the GEMMs in TF32?")
    del gk, gp, g64

    # ---- bce_logits at the fit step's shape [R·4096, B] ----
    sel, wt = idx_b[0].to(dev), w_b[0].to(dev)
    scale = 1.0 / (R * max(float(wt.sum()), 1.0))
    with torch.no_grad():
        xb = scorer_logits(params, train[sel]).reshape(-1, B)
        yb = PT.bucket_targets(idx.assign, labels[sel], ones, B).reshape(
            -1, B)
    lk, gk = bops.bce_logits(xb, yb, wt, scale=scale)
    lp, gp = weighted_bce_ref(xb, yb, wt, scale)
    torch.cuda.synchronize()
    # each gradient element is scale·w·(σ(x) - y), at most 7.6e-6 here: hold
    # it in σ(x) - y's own units, where TOL means what it says
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    grad_err = bce_grad_err(gk, gp, wt, scale)
    bce_err = max(loss_rel, grad_err)
    log(f"bce_logits {tuple(xb.shape)}: loss kernel {float(lk):.8f}, plain "
        f"{float(lp):.8f} (relative error {loss_rel:.3g}); gradient max "
        f"|kernel - plain| / (scale·w), the error in σ(x) - y: "
        f"{grad_err:.3g} (zero-weight rows exactly 0)")
    if not (loss_rel <= TOL and grad_err <= TOL):
        raise AssertionError("bce_logits differs from its plain version")
    del gk, gp
    torch.cuda.empty_cache()
    bce_ms = time_ms(torch, lambda: bops.bce_logits(xb, yb, wt, scale=scale),
                     n=10)
    bce_plain = time_ms(torch, lambda: weighted_bce_ref(xb, yb, wt, scale),
                        n=3, warmup=1)

    def bce_library():
        return (F.binary_cross_entropy_with_logits(xb, yb, reduction="sum"),
                torch.sigmoid(xb) - yb)

    bce_lib = time_ms(torch, bce_library, n=3, warmup=1)
    n_el = xb.numel()
    bce_cost = bops.cost(*xb.shape, wt.numel())
    bce_bound = bound(bce_cost["flops"], bce_cost["bytes"])
    log(f"bce_logits: {12 * n_el / 1e9:.2f} GB in+out -> bound "
        f"{bce_bound[0]:.4f} ms ({bce_bound[1]}); kernel {bce_ms:.4f} ms "
        f"({12 * n_el / bce_ms / 1e6:.1f} GB/s), plain {bce_plain:.4f} ms, "
        f"library (binary_cross_entropy_with_logits + sigmoid - y) "
        f"{bce_lib:.4f} ms")
    del xb, yb
    torch.cuda.empty_cache()

    # ---- the affinity pass: peak memory, time, a chunk against plain ----
    data = FitData.build(train, labels, label_vecs=base, n_labels=FIT_L,
                         chunk=FIT_CHUNK, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    vals, ids = eng.affinity_topk(params, data)
    e1.record()
    e1.synchronize()
    aff_ms = e0.elapsed_time(e1)
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    # what the streamed design holds: the label vectors cut into chunks, one
    # chunk's [R, chunk, H] hidden layer, the running [R, L, K] top-K
    # (values and ids) and one chunk's irli_topk output and probabilities
    n_lab = data.label_vecs.shape[0]
    n_pad = -(-n_lab // FIT_CHUNK) * FIT_CHUNK
    design = (n_pad * D * 4 + R * FIT_CHUNK * H * 4 + R * n_pad * FIT_K * 8
              + R * FIT_CHUNK * (FIT_K * 12 + 4)) / 1e9
    block = R * FIT_CHUNK * B * 4 / 1e9
    log(f"affinity pass ({n_lab} labels, chunk {FIT_CHUNK}): {aff_ms:.2f} ms; "
        f"peak device memory {peak:.3f} GB above its inputs, against "
        f"{design:.3f} GB that the streamed design holds (limit 1.1 x that; "
        f"one [R, chunk, B] fp32 block would be {block:.1f} GB)")
    if not peak <= 1.1 * design:
        raise AssertionError(f"the affinity pass peaked at {peak} GB, past "
                             f"1.1 x the {design} GB its design holds")
    h = scorer_hidden(params, base[:2048])
    irli_err = check_irli(f"fit affinity chunk (2048 labels, m=K={FIT_K})",
                          h, params["w2"], params["b2"], FIT_K)
    del h, vals

    # ---- kchoice at the fit's shape (real affinities and uniform lists),
    # the insert's and the worst case, each against the plain loop and its
    # window schedule ----
    orders = insertion_orders(R, FIT_L, dev,
                              torch.Generator().manual_seed(SEED)).int()
    ids = ids.contiguous()
    link = kops.step_cycles(dev)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    log(f"kchoice's chain link, a min and an add in registers measured on "
        f"this card: {link:.2f} clocks at {sm_clock / 1e6:.0f} MHz")
    k_ms, k_plain, k_bound = kchoice_check(
        torch, "the fit's shape (real affinities)", ids, orders, None, None,
        link, sm_clock, n=5)
    # a balanced partition's lists: long clean prefixes, the window path
    kchoice_check(torch, f"the fit's reps over {UNIFORM_L} labels "
                  f"(uniform lists)",
                  uniform_lists(torch, R, UNIFORM_L, FIT_K, SEED).to(dev),
                  insertion_orders(R, UNIFORM_L, dev, torch.Generator()
                                   .manual_seed(SEED)).int(),
                  None, None, link, sm_clock, n=5)
    s_ids = ids[:, :INSERT_BATCH].contiguous()
    s_orders = insertion_orders(R, INSERT_BATCH, dev,
                                torch.Generator().manual_seed(SEED)).int()
    s_load = torch.full((R, B), float(FIT_L // B), device=dev)
    s_w = torch.ones(INSERT_BATCH, device=dev)
    kchoice_check(torch, "the stream's insert shape (loads and weights "
                  "given)", s_ids, s_orders, s_load, s_w, link, sm_clock)
    # the worst case: every label of a rep on one K-list, so each label
    # waits on the one before it (depth = L)
    lists = torch.stack([torch.randperm(B, generator=torch.Generator()
                                        .manual_seed(SEED + r))[:FIT_K]
                         for r in range(R)]).int().to(dev)
    w_ids = lists[:, None, :].expand(R, INSERT_BATCH, FIT_K).contiguous()
    kchoice_check(torch, "the worst case (one K-list a rep)", w_ids,
                  s_orders, None, None, link, sm_clock, worst=True)
    del s_ids, s_orders, s_load, s_w, lists, w_ids

    # ---- one train step split into its stages (CUDA events) ----
    x_in = train[sel]

    def split_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        tg = PT.bucket_targets(idx.assign, labels[sel], ones, B)
        ev[1].record()
        for k in keys:
            params[k].requires_grad_(True)
        hh = scorer_hidden(params, x_in)
        ev[2].record()
        lg = torch.bmm(hh, params["w2"]).add_(params["b2"][:, None, :])
        ev[3].record()
        loss = bops.sigmoid_bce_loss(lg, tg, wt, scale=scale)
        del lg, tg
        ev[4].record()
        g = torch.autograd.grad(loss, [params[k] for k in keys])
        for k in keys:
            params[k].requires_grad_(False)
        ev[5].record()
        g = dict(zip(keys, g))
        apply_clip(g, torch.sqrt(global_norm_sq(g)), 1.0)
        eng.opt.update(params, g, idx.opt_state)
        ev[6].record()
        ev[6].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]

    split_step()
    runs = [split_step() for _ in range(3)]
    names = ["targets (bucket_targets)", "first layer (matmul)",
             "output GEMM (bmm + bias)", "bce_logits (loss + gradient)",
             "backward (autograd GEMMs)", "clip + AdamW"]
    med = [statistics.median(r[i] for r in runs) for i in range(6)]
    for name, ms in zip(names, med):
        log(f"fit stage {name}: {ms:.4f} ms")
    log(f"fit stage whole train step: {sum(med):.4f} ms; affinity pass "
        f"{aff_ms:.4f} ms; kchoice {k_ms:.4f} ms; build_index "
        f"{build_ms:.4f} ms; whole round (host clock, from the fit) "
        f"{', '.join('%.1f' % (r['seconds'] * 1e3) for r in rows)} ms")

    # ---- round 1 again, kernel-free ----
    del idx, params, data, ids, x_in
    torch.cuda.empty_cache()
    same = plain_round_check(torch, dev, run)
    del run
    torch.cuda.empty_cache()

    # ---- one round of the paper's softmax_bce ----
    sbase, _, _ = clustered_vectors(n_base=SOFT_L, n_queries=1, d=D,
                                    seed=SEED + 1)
    sbase = torch.from_numpy(sbase).to(dev)
    slabels = neighbours(torch, dev, sbase, sbase, K_NEIGH)
    scfg = IRLIConfig(d=D, n_labels=SOFT_L, n_buckets=B, n_reps=R,
                      d_hidden=H, K=FIT_K, rounds=1, epochs_per_round=1,
                      batch_size=SOFT_BATCH, lr=1e-3, loss="softmax_bce",
                      affinity_chunk=FIT_CHUNK, seed=SEED)
    sidx = IRLIIndex(scfg, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sst = sidx.fit(sbase, slabels, label_vecs=sbase)
    torch.cuda.synchronize()
    slaunch = {n: c for n, c in LAUNCHES.items() if c}
    log(f"softmax_bce fit, 1 round over {SOFT_L} labels at batch "
        f"{SOFT_BATCH}: {time.perf_counter() - t0:.2f} s, loss "
        f"{sst.train_loss}, reassigned {sst.n_reassigned}, load std "
        f"{sst.load_std}; launches {slaunch}")
    if slaunch != {"irli_topk": 1, "kchoice": 1}:
        raise AssertionError(f"the softmax_bce fit launched {slaunch}")
    if not all(torch.isfinite(v).all() for v in sidx.params.values()):
        raise AssertionError("the softmax_bce fit left non-finite weights")
    del sidx, base, train, labels
    torch.cuda.empty_cache()
    return {"launches": launches,
            "record": {"bce_logits": {"max_abs_err": bce_err},
                       "kchoice": {"max_abs_err": 0.0}},
            "times": {"bce_logits": (bce_ms, bce_plain, bce_lib),
                      "kchoice": (k_ms, k_plain, None)},
            "bounds": {"bce_logits": bce_bound, "kchoice": k_bound},
            "irli_err": irli_err, "dist_err": dist_err,
            "neighbours": {"neighbours_ms": nb_ms,
                           "neighbours_plain_ms": nb_plain,
                           "neighbours_library_ms": nb_lib,
                           "neighbours_bound_ms": nb_bound[0]},
            "dense_launches": dense_launches, "baselines": baselines}


def exact_attention(q, k, v):
    """The plain version on fp32 copies of bf16 q, k, v, cast back: the
    probabilities stay fp32 (no bf16 rounding of P), the yardstick that
    both the kernel's and the plain version's bf16 rounding are measured
    against."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    return flash_attention_ref(q.float(), k.float(), v.float(),
                               q_chunk=1024).to(q.dtype)


@contextlib.contextmanager
def plain_attention(exact: bool = False):
    """attend_train's causal attention through the plain version (ref.py,
    in query chunks of 1024: no launch) instead of the kernel, or with
    ``exact`` through :func:`exact_attention`; only for the comparison of
    a whole prefill."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import attention as A
    kernel = A.causal_attention
    A.causal_attention = exact_attention if exact else (
        lambda q, k, v: flash_attention_ref(q, k, v, q_chunk=1024))
    try:
        yield
    finally:
        A.causal_attention = kernel


@contextlib.contextmanager
def first_layer_qkv(store: list):
    """Keep the q, k, v of attend_train's first causal_attention call (one
    layer's real inputs) in ``store``; the call itself is unchanged."""
    from repro_torch.models import attention as A
    kernel = A.causal_attention

    def keep(q, k, v):
        if not store:
            store.extend((q, k, v))
        return kernel(q, k, v)
    A.causal_attention = keep
    try:
        yield
    finally:
        A.causal_attention = kernel


def flash_bound(torch, q, k, v):
    """flash_attention's least time at these inputs: the causal pairs'
    operations at the bf16 (or fp32) peak against q, k, v and o once at the
    memory rate -> (ms, bound_by, flops)."""
    from repro_torch.kernels.flash_attention import ops as faops
    B, H, S, D = q.shape
    c = faops.cost(B, H, k.shape[1], S, D, itemsize=q.element_size())
    flops, nbytes = float(c["flops"]), c["bytes"]
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    ms, by = max((flops / peak * 1e3, "operations"),
                 (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    return ms, by, flops


def flash_check(torch, name, q, k, v) -> float:
    """flash_attention on one layer's real q, k, v against its plain
    version (query chunks of 1024), in q's dtype and, at S <= 2048, in
    fp32 too; the reference test's tolerances (bf16 rtol/atol 3e-2, fp32
    2e-4). In bf16 both are also measured against exact_attention (fp32
    probabilities): the kernel's relative L2 error may not pass 1.25
    times the plain version's. Returns the max abs error."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    cases = [(q, k, v)]
    if q.shape[2] <= 2048:
        cases.append(tuple(t.float() for t in (q, k, v)))
    err = 0.0
    for qq, kk, vv in cases:
        o = faops.flash_attention(qq, kk, vv)
        ref = flash_attention_ref(qq, kk, vv, q_chunk=1024)
        torch.cuda.synchronize()
        tol = 3e-2 if qq.dtype == torch.bfloat16 else 2e-4
        d = (o.float() - ref.float()).abs()
        bad = int((d > tol + tol * ref.float().abs()).sum())
        log(f"flash_attention {name} {qq.dtype} q {tuple(qq.shape)} k "
            f"{tuple(kk.shape)}: max |kernel - plain| {float(d.max()):.3e}"
            f", {bad} elements outside {tol:g} + {tol:g}·|plain|")
        if bad or not bool(torch.isfinite(o.float()).all()):
            raise AssertionError(f"flash_attention {name} {qq.dtype}: "
                                 f"{bad} elements outside the tolerance")
        if qq.dtype == torch.bfloat16:
            ex = exact_attention(qq, kk, vv).float()
            ek = float((o.float() - ex).norm() / ex.norm())
            ep = float((ref.float() - ex).norm() / ex.norm())
            log(f"flash_attention {name}: relative L2 error against the "
                f"fp32-probability attention: kernel {ek:.4e}, plain "
                f"{ep:.4e} (limit 1.25 x plain)")
            if ek > 1.25 * ep:
                raise AssertionError(f"flash_attention {name}: the kernel's"
                                     f" error {ek:.3e} passes 1.25 x the "
                                     f"plain version's {ep:.3e}")
            del ex
        err = max(err, float(d.max()))
        del o, ref, d
    return err


def prefill_check(torch, name, out, plain, exact) -> int:
    """A prefill against the same prefill with the plain attention and with
    exact_attention. The last hidden state: relative L2 error against the
    plain prefill <= PREFILL_TOL, and against the exact prefill at most
    1.25 times the plain prefill's (both bf16 attentions round P once an
    element; 28 random layers carry any such rounding to about 2.4e-2,
    PERF.md). Next tokens equal the plain prefill's except rows whose plain
    top-2 gap is under 2e-2·|top|. Returns those rows' count."""
    h, ph = out["hidden"].float(), plain["hidden"].float()
    eh = exact["hidden"].float()
    rel = float((h - ph).norm() / ph.norm())
    rel_k = float((h - eh).norm() / eh.norm())
    rel_p = float((ph - eh).norm() / eh.norm())
    top2 = plain["logits"].topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) < 2e-2 * top2[:, 0].abs()
    differ = out["next_token"] != plain["next_token"]
    log(f"{name}: hidden rel L2 kernel vs plain {rel:.4e} (limit "
        f"{PREFILL_TOL:g}); against the fp32-probability prefill: kernel "
        f"{rel_k:.4e}, plain {rel_p:.4e} (limit 1.25 x plain); next tokens "
        f"{out['next_token'].tolist()[:8]} (plain "
        f"{plain['next_token'].tolist()[:8]}, fp32-probability "
        f"{exact['next_token'].tolist()[:8]}); {int(differ.sum())} differ, "
        f"{int(near.sum())} of {len(near)} rows a near tie at the top-2")
    if not (bool(torch.isfinite(out["logits"]).all())
            and bool(torch.isfinite(h).all())):
        raise AssertionError(f"{name}: non-finite prefill output")
    if rel > PREFILL_TOL or rel_k > 1.25 * rel_p:
        raise AssertionError(f"{name}: hidden rel L2 {rel:.3e} against the "
                             f"plain prefill (limit {PREFILL_TOL:g}), "
                             f"{rel_k:.3e} against the fp32-probability "
                             f"prefill (limit 1.25 x {rel_p:.3e})")
    if bool((differ & ~near).any()):
        raise AssertionError(f"{name}: next tokens differ outside the "
                             f"near ties")
    return int(near.sum())


ATTENTION = "flash_attention (flash_*_kernel)"
FLASH_KERNELS = ("flash_bf16_wgmma_kernel", "flash_f32_kernel")  # names


def device_split(torch, run, names, label, require: bool = True,
                 warm: bool = True) -> tuple[float, dict, int, int]:
    """One warm ``run()`` under torch.profiler (``warm=False``: the caller
    has warmed it; no extra call) -> its device time (ms),
    that time by group, the number of the port's kernels it ran and the
    number of all the kernels it ran. The
    groups: the port's kernels (``names``: parts of their demangled names)
    as ``label``, which no aten op launches; every other kernel by the aten
    op the trace ties it to; the rest (kernels the trace ties to no aten
    op, such as those behind a "Command Buffer Full" marker) together."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.trace import LEAD_IN, LEAD_IN_KERNEL

    def ours(name):
        return any(k in name for k in names)
    if warm:
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # in a long run the profiler drops a window's first kernels
        # (PERF.md §7): lead-in kernels take that loss, uncounted
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and LEAD_IN_KERNEL not in e.name]
    if not dev:
        raise AssertionError(f"torch.profiler traced no device activity "
                             f"({label})")
    total = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    mine = [e.time_range.elapsed_us() / 1e3 for e in dev if ours(e.name)]
    split = {label: sum(mine)}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.name.startswith("aten::"):
            for kern in e.kernels:
                if not ours(kern.name):
                    split[e.name] = split.get(e.name, 0.0) \
                        + kern.duration / 1e3
    split["kernels tied to no aten op"] = total - sum(split.values())
    if require and not mine:
        raise AssertionError(f"no {label} kernel in the trace; its "
                             f"kernels: {sorted({e.name[:80] for e in dev})}")
    return total, dict(sorted(split.items(), key=lambda kv: -kv[1])), \
        len(mine), len(dev)


def lm_cell(torch, dev) -> dict:
    """The LM prefill cell: gemma-7b at full width and depth (random bf16
    weights from SEED), build_lm_prefill at [4, 2048] and [1, 32768];
    flash_attention once a layer and no other kernel, the kernel against
    its plain version on layer 0's q, k, v, each prefill against the same
    prefill with the plain attention, the times; then qwen3-4b (4 of 36
    layers) at [4, 2048], the GQA and head_dim 128 case. Between the two,
    on gemma-7b's model: its decode (decode_phase) and the IRLI vocabulary
    head (head_phase) on the [4, 2048] prefill's last hidden state and on
    the first decode step's. Returns the launches by path, the record,
    times and bound, and the decode's and the head's numbers."""
    import dataclasses

    from repro_torch.configs.gemma_7b import CONFIG as GEMMA
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.steps import build_lm_prefill
    from repro_torch.models.module import param_bytes, param_count
    from repro_torch.models.transformer import lm_init

    attrs = faops.kernel_attrs()
    log("flash_attention bf16 kernel (cudaFuncGetAttributes): " + "; ".join(
        f"DT {dt}: {a['registers']} registers a thread at launch, "
        f"{a['spill_bytes']} spill bytes, {a['smem_bytes']} bytes of shared "
        f"memory a block" for dt, a in attrs.items()))
    if any(a["spill_bytes"] for a in attrs.values()):
        raise AssertionError(f"flash_attention spills registers: {attrs}")
    launches, err, near, times, serving = {}, 0.0, 0, {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for cfg, shapes in ((GEMMA, LM_SHAPES),
                        (dataclasses.replace(QWEN, n_layers=QWEN_LAYERS),
                         LM_SHAPES[:1])):
        t0 = time.perf_counter()
        model = lm_init(cfg, seed=SEED, device=dev)
        torch.cuda.synchronize()
        log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads} heads over {cfg.n_kv_heads} x {cfg.head_dim}, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab}: {param_count(model)} "
            f"params ({param_bytes(model) / 1e9:.2f} GB bf16), init "
            f"{time.perf_counter() - t0:.2f} s")
        step = build_lm_prefill(cfg)
        for bsz, seq in shapes:
            name = f"{cfg.name} prefill [{bsz}, {seq}]"
            tokens = torch.randint(0, cfg.vocab, (bsz, seq), generator=gen,
                                   device=dev)
            batch = {"tokens": tokens}
            qkv = []
            torch.cuda.synchronize()
            reset_launches()
            with first_layer_qkv(qkv):
                out = step(model, batch)
            torch.cuda.synchronize()
            got = {n: c for n, c in LAUNCHES.items() if c}
            if got != {"flash_attention": cfg.n_layers}:
                raise AssertionError(f"{name} launched {got}, not one "
                                     f"flash_attention a layer")
            launches[name] = got["flash_attention"]
            if out["logits"].shape != (bsz, cfg.vocab) \
                    or out["logits"].dtype != torch.float32:
                raise AssertionError(f"{name}: logits "
                                     f"{tuple(out['logits'].shape)}")
            with plain_attention():
                plain = step(model, batch)
            with plain_attention(exact=True):
                exact = step(model, batch)
            near += prefill_check(torch, name, out, plain, exact)
            if cfg is GEMMA and (bsz, seq) == LM_SHAPES[0]:
                head_in = {f"prefill [{bsz}, {seq}]": out["hidden"].clone()}
            del plain, exact
            q, k, v = qkv
            err = max(err, flash_check(torch, f"({name}, layer 0)", q, k,
                                       v))
            n_runs = 3 if seq > 4096 else 10
            pre_ms = time_ms(torch, lambda: step(model, batch), n=n_runs,
                             warmup=1)
            att_ms = time_ms(torch, lambda: faops.flash_attention(q, k, v),
                             n=n_runs, warmup=1)
            # the wrapper's count is read around each traced call: a
            # second trace only when the prefill launched every layer's
            # kernel and the trace saw fewer (the profiler may drop
            # kernels, PERF.md §7), so a launch that is missing fails
            for _ in range(2):
                reset_launches()
                traced, split, n_att, _ = device_split(
                    torch, lambda: step(model, batch), FLASH_KERNELS,
                    ATTENTION, warm=False)
                n_call = LAUNCHES["flash_attention"]
                if n_att == cfg.n_layers or n_call != cfg.n_layers:
                    break
                log(f"{name}: the trace saw {n_att} flash_attention "
                    f"kernels of the {n_call} the wrapper launched; "
                    f"traced again")
            if n_call != cfg.n_layers or n_att != cfg.n_layers:
                raise AssertionError(f"{name}: the traced prefill "
                                     f"launched {n_call} flash_attention "
                                     f"kernels and the trace saw {n_att}, "
                                     f"not {cfg.n_layers}")
            tok_s = bsz * seq / pre_ms * 1e3
            # the projections' and MLPs' GEMMs, the causal attention and
            # the last position's logits; the weights read once
            d, hd = cfg.d_model, cfg.head_dim
            lin = d * hd * 2 * (cfg.n_heads + cfg.n_kv_heads) \
                + 3 * d * cfg.d_ff
            flops = cfg.n_layers * (2.0 * bsz * seq * lin + 2.0 * bsz
                                    * cfg.n_heads * seq * (seq + 1) * hd) \
                + 2.0 * bsz * d * cfg.vocab
            pre_bound, pre_by = max(
                (flops / BF16_FLOPS * 1e3, "operations at the bf16 peak"),
                (param_bytes(model) / HBM_BYTES_PER_S * 1e3,
                 "the weights at the memory rate"))
            log(f"{name}: prefill {pre_ms:.4f} ms ({tok_s:.1f} tokens/s), "
                f"next tokens {out['next_token'].tolist()}; one "
                f"attention call alone {att_ms:.4f} ms; {flops / 1e12:.1f} "
                f"TFLOP -> bound {pre_bound:.1f} ms ({pre_by}), "
                f"{pre_bound / pre_ms:.1%} of it reached")
            log(f"{name}: one traced prefill (torch.profiler), device time "
                f"{traced:.4f} ms, {n_att} flash_attention kernels; "
                f"attention {split[ATTENTION] / traced:.1%} of it; by "
                f"group: "
                + "; ".join(f"{n} {t:.4f} ms ({t / traced:.1%})"
                            for n, t in split.items()))
            if cfg is GEMMA:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                o = faops.flash_attention(q, k, v)
                torch.cuda.synchronize()
                extra = (torch.cuda.max_memory_allocated() - before
                         - o.numel() * o.element_size())
                log(f"{name}: the attention call's peak device memory "
                    f"above its inputs and output: {extra / 1e6:.3f} MB "
                    f"(limit 64 MB)")
                if extra >= 64e6:
                    raise AssertionError(f"{name}: the attention call "
                                         f"holds {extra / 1e6:.1f} MB")
                del o
            bms, by, flops = flash_bound(torch, q, k, v)
            plain_ms = time_ms(torch, lambda: flash_attention_ref(
                q, k, v, q_chunk=1024), n=1 if seq > 4096 else 3,
                warmup=1)
            sdpa_ms = time_ms(torch, lambda: torch.nn.functional
                              .scaled_dot_product_attention(
                                  q, k, v, is_causal=True, enable_gqa=True),
                              n=n_runs, warmup=1)
            log(f"flash_attention at {name} q {tuple(q.shape)} k "
                f"{tuple(k.shape)}: {flops / 1e12:.4f} TFLOP -> bound "
                f"{bms:.4f} ms ({by}); kernel {att_ms:.4f} ms "
                f"({flops / att_ms / 1e9:.1f} TFLOP/s), plain (ref.py, "
                f"query chunks of 1024) {plain_ms:.4f} ms, library "
                f"(scaled_dot_product_attention) {sdpa_ms:.4f} ms "
                f"({flops / sdpa_ms / 1e9:.1f} TFLOP/s); kernel / library "
                f"{att_ms / sdpa_ms:.3f}")
            times[name] = (att_ms, plain_ms, sdpa_ms, (bms, by))
            del out, qkv, q, k, v, batch, tokens
            torch.cuda.empty_cache()
        if cfg is GEMMA:
            t0 = time.perf_counter()
            serving["decode"] = decode_phase(torch, dev, model, cfg, gen)
            head_in["decode step 0"] = serving["decode"].pop("hidden")
            serving["head"] = head_phase(torch, dev, model, cfg, head_in)
            del head_in
            log(f"gemma-7b decode and vocabulary head: "
                f"{time.perf_counter() - t0:.1f} s")
        del model, step
        torch.cuda.empty_cache()
    log(f"lm cell: {near} prefill rows had a near tie at the top-2")
    att_ms, plain_ms, sdpa_ms, bnd = times[
        f"{GEMMA.name} prefill [{LM_SHAPES[1][0]}, {LM_SHAPES[1][1]}]"]
    return {"launches": launches, "err": err,
            "times": (att_ms, plain_ms, sdpa_ms), "bound": bnd, **serving}


def rel_l2(a, b) -> float:
    """‖a − b‖ / ‖b‖ in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def decode_phase(torch, dev, model, cfg, gen) -> dict:
    """gemma-7b's decode at full width and depth (the prefill's model):
    build_lm_decode(cfg, DECODE_CTX) at B = DECODE_B over init_cache. 16
    steps from pos 0 held to lm_backbone + _logits over the same tokens,
    teacher-forced (the forward attends through flash_attention, the
    decode through _sdpa): each position's logits within DECODE_TOL
    relative L2, next tokens equal outside near ties; then a step at pos
    DECODE_POS of a cache filled with random bf16 values, timed beside its
    byte bound (the weights and the whole cache read once). Returns the
    first step's final hidden state (the vocabulary head's decode input)
    and the numbers."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import build_lm_decode
    from repro_torch.models.module import param_bytes
    from repro_torch.models.transformer import (_logits, init_cache,
                                                lm_backbone)

    B, n = DECODE_B, DECODE_STEPS
    t0 = time.perf_counter()
    caches = init_cache(cfg, B, DECODE_CTX, device=dev)
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c.values())
    step = build_lm_decode(cfg, DECODE_CTX)
    toks = torch.randint(0, cfg.vocab, (B, n), generator=gen, device=dev)
    logits, first_h = [], None
    torch.cuda.synchronize()
    reset_launches()
    for t in range(n):
        out = step(model, {"token": toks[:, t], "caches": caches,
                           "pos": torch.full((B,), t, device=dev)})
        logits.append(out["logits"])
        if first_h is None:
            first_h = out["hidden"].clone()
    torch.cuda.synchronize()
    launches = {k: c for k, c in LAUNCHES.items() if c}
    if launches:
        raise AssertionError(f"gemma decode launched {launches}: its "
                             f"attention is _sdpa")
    with torch.inference_mode():
        h, _ = lm_backbone(model, cfg, toks)
        full = _logits(model, cfg, h)                         # [B, n, V]
    errs, near = [], 0
    for t in range(n):
        errs.append(rel_l2(logits[t], full[:, t]))
        top2 = full[:, t].topk(2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) < 2e-2 * top2[:, 0].abs()
        differ = logits[t].argmax(-1) != full[:, t].argmax(-1)
        if bool((differ & ~tie).any()):
            raise AssertionError(f"gemma decode step {t}: next tokens "
                                 f"differ from the forward's outside the "
                                 f"near ties")
        near += int(tie.sum())
    log(f"gemma-7b decode (B {B}, context {DECODE_CTX}, cache "
        f"{cache_bytes / 1e9:.2f} GB bf16): {n} steps from pos 0 against "
        f"the teacher-forced forward (lm_backbone + _logits, flash_attention"
        f"): logits rel L2 max {max(errs):.4e} (limit {DECODE_TOL:g}), by "
        f"step {[f'{e:.2e}' for e in errs]}; {near} of {B * n} rows a near "
        f"tie at the top-2; no kernel launched")
    if not max(errs) <= DECODE_TOL:
        raise AssertionError(f"gemma decode: logits rel L2 {max(errs):.3e} "
                             f"against the forward (limit {DECODE_TOL})")
    del full, h, logits
    for c in caches:
        for t in c.values():
            t.normal_(generator=gen)
    batch = {"token": toks[:, -1], "caches": caches,
             "pos": torch.full((B,), DECODE_POS, device=dev)}
    step_ms = time_ms(torch, lambda: step(model, batch), n=10, warmup=2)
    traced, split, _, n_kern = device_split(
        torch, lambda: step(model, batch), (), "the port's kernels",
        require=False)
    log(f"gemma-7b decode step: one traced step (torch.profiler), device "
        f"time {traced:.4f} ms in {n_kern} kernels; by group: "
        + "; ".join(f"{g} {t:.4f} ms ({t / traced:.1%})"
                    for g, t in list(split.items())[:8]))
    w_bytes = param_bytes(model)
    flops = 2.0 * B * (w_bytes / 2) + 4.0 * B * cfg.n_heads * cfg.head_dim \
        * DECODE_CTX * cfg.n_layers
    bms, by = bound(flops, w_bytes + cache_bytes)
    log(f"gemma-7b decode step at pos {DECODE_POS} (cache filled with random "
        f"bf16): {step_ms:.4f} ms a step, {B / step_ms * 1e3:.1f} tokens/s; "
        f"bound {bms:.4f} ms ({by}: {w_bytes / 1e9:.2f} GB of weights and "
        f"{cache_bytes / 1e9:.2f} GB of cache read once), {bms / step_ms:.1%}"
        f" of it reached; set-up and checks {time.perf_counter() - t0:.1f} s")
    del caches, batch
    torch.cuda.empty_cache()
    return {"hidden": first_h, "step_ms": step_ms, "bound": (bms, by),
            "tol": max(errs)}


def head_phase(torch, dev, model, cfg, inputs) -> dict:
    """The IRLI vocabulary head over gemma-7b's 256,000 tokens: B = HEAD_B
    buckets, R = HEAD_R reps of the hash partition (max_load 2·V/B), a
    random softmax_bce scorer (d_in d_model, d_hidden HEAD_H), m = HEAD_M,
    on each of ``inputs`` (name -> final hidden [Bq, d]). The probe (one
    irli_topk launch) against top_buckets outside near ties; the candidate
    ids against the plain gather of its buckets; every candidate logit
    against the full _logits at that id (TOL); the greedy token against
    the argmax of the full logits over the candidate set (near ties
    exempt). Times and bytes read beside the full head's. Returns the
    launches and times."""
    from repro_torch.core import partition as PTN
    from repro_torch.core import vocab_head as PV
    from repro_torch.core.network import (ScorerConfig, scorer_init,
                                          scorer_logits)
    from repro_torch.core.query import gather_members, top_buckets
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.irli_topk.ref import near, same_topm
    from repro_torch.launch.steps import next_token
    from repro_torch.models.transformer import _logits

    V, Bk, R, m = cfg.vocab, HEAD_B, HEAD_R, HEAD_M
    index = PTN.build_inverted_index(PTN.hash_init(V, Bk, R, SEED,
                                                   device=dev), Bk,
                                     max_load=2 * V // Bk)
    sp = scorer_init(ScorerConfig(d_in=cfg.d_model, d_hidden=HEAD_H,
                                  n_buckets=Bk, n_reps=R),
                     torch.Generator(device=dev).manual_seed(SEED))
    table = model["embed"]["table"]
    C = R * m * index.max_load
    launches, times = 0, {}
    for name, h in inputs.items():
        Bq = h.shape[0]
        torch.cuda.synchronize()
        reset_launches()
        cands, logits = PV.candidate_token_logits(sp, index, table, h, m=m)
        torch.cuda.synchronize()
        got = {k: c for k, c in LAUNCHES.items() if c}
        if got != {"irli_topk": 1}:
            raise AssertionError(f"vocab head ({name}) launched {got}, not "
                                 f"one irli_topk")
        launches += 1
        bidx = PV.probe_buckets(sp, h, m)
        pv, pi = top_buckets(sp, h, m + 1)
        lg = scorer_logits(sp, h)
        cut, order = same_topm(lg.gather(-1, bidx.long()), bidx,
                               lg.gather(-1, pi), pi, TOL)
        if not torch.equal(cands, gather_members(index.members, bidx)):
            raise AssertionError(f"vocab head ({name}): candidates differ "
                                 f"from the plain gather")
        plain = gather_members(index.members, pi[..., :m])
        rows_same = int((plain == cands).all(1).sum())
        with torch.inference_mode():
            full = _logits(model, cfg, h)                       # [Bq, V]
        valid = cands >= 0
        want = full.gather(1, cands.clamp(min=0).long())
        ok = near(logits, want, TOL) | ~valid
        if not bool(ok.all()) or not bool(torch.isinf(logits[~valid]).all()):
            raise AssertionError(f"vocab head ({name}): "
                                 f"{int((~ok).sum())} candidate logits off "
                                 f"the full head's")
        tok = PV.greedy_token(sp, index, table, h, m=m)
        in_set = torch.zeros_like(full, dtype=torch.bool)
        in_set.scatter_(1, cands.clamp(min=0).long(), valid)
        ref_tok = full.masked_fill(~in_set, float("-inf")).argmax(1)
        same = tok.long() == ref_tok
        tie = near(full.gather(1, tok.long()[:, None])[:, 0],
                   full.gather(1, ref_tok[:, None])[:, 0], TOL)
        if not bool((same | tie).all()):
            raise AssertionError(f"vocab head ({name}): greedy token off "
                                 f"the full head's argmax over the "
                                 f"candidates")
        covered = int((tok.long() == full.argmax(1)).sum())
        distinct = statistics.mean(torch.unique(r[r >= 0]).numel()
                                   for r in cands)
        head_ms = time_ms(torch, lambda: PV.greedy_token(sp, index, table, h,
                                                         m=m), n=10)
        traced, split, _, n_kern = device_split(
            torch, lambda: PV.greedy_token(sp, index, table, h, m=m),
            ("irli_topk_kernel",), "irli_topk (the probe)")
        log(f"vocab head ({name}): one traced call (torch.profiler), device "
            f"time {traced:.4f} ms in {n_kern} kernels; by group: "
            + "; ".join(f"{g} {t:.4f} ms ({t / traced:.1%})"
                        for g, t in list(split.items())[:8]))
        full_ms = time_ms(torch, lambda: next_token(_logits(model, cfg, h)),
                          n=10)
        sp_bytes = sum(t.numel() * t.element_size() for t in sp.values())
        head_bytes = sp_bytes + Bq * C * (4 + table.shape[1]
                                          * table.element_size())
        full_bytes = table.numel() * table.element_size()
        log(f"vocab head ({name}, Bq {Bq}): V {V}, B {Bk}, R {R}, max_load "
            f"{index.max_load}, m {m}: C = {C} candidates a query "
            f"({distinct:.1f} distinct), probe = one irli_topk launch, "
            f"against top_buckets: {cut} rows a near tie at the m cut, "
            f"{order} in another order; {rows_same} of {Bq} rows' "
            f"candidates equal the plain probe's gather; candidate logits "
            f"within {TOL:g} of the full head; greedy token = the full "
            f"argmax in {covered} of {Bq} rows; head {head_ms:.4f} ms "
            f"(reads {head_bytes / 1e6:.1f} MB: the scorer "
            f"{sp_bytes / 1e6:.1f} MB, the candidates' ids and rows) against "
            f"the full _logits + next_token {full_ms:.4f} ms (reads the "
            f"{full_bytes / 1e9:.3f} GB table)")
        times[name] = (head_ms, full_ms)
    del index, sp
    torch.cuda.empty_cache()
    return {"launches": launches, "times": times}


@contextlib.contextmanager
def recorded_routes(store: list):
    """Keep each MoE routing's (router, logits, ids) in ``store``, in call
    order; the routing itself is unchanged."""
    from repro_torch.models import moe as MOE
    route = MOE._route

    def keep(logits, cfg):
        w, idx, aux = route(logits, cfg)
        store.append((cfg.router, logits, idx))
        return w, idx, aux
    MOE._route = keep
    try:
        yield
    finally:
        MOE._route = route


@contextlib.contextmanager
def plain_router():
    """The MoE router's k-choice walk through kchoice_ref (no launch)."""
    from repro_torch.kernels.kchoice.ref import kchoice_ref
    from repro_torch.models import moe as MOE
    assign = MOE.kchoice_assign
    MOE.kchoice_assign = lambda t, o, l0=None, w=None, *, B, slots=1: \
        kchoice_ref(t, o, l0, w, B=B, slots=slots)
    try:
        yield
    finally:
        MOE.kchoice_assign = assign


def router_check(torch, name, routes, mcfg):
    """Every recorded k-choice routing equals kchoice_ref with the same
    slots on the same router logits, bit for bit. Returns the first plain
    walk and its host time in ms."""
    from repro_torch.core.topk import topk_stable
    from repro_torch.kernels.kchoice.ref import kchoice_ref
    K = max(mcfg.router_k_choices, mcfg.top_k)
    first = None
    for router, logits, idx in routes:
        if router != "irli_kchoice":
            continue
        topi = topk_stable(torch.softmax(logits.float(), -1), K)[1]
        topi = topi.reshape(-1, *topi.shape[-2:]).to(torch.int32)
        G, T = topi.shape[:2]
        order = torch.arange(T, dtype=torch.int32,
                             device=topi.device).expand(G, T)
        t0 = time.perf_counter()
        want = kchoice_ref(topi, order, B=mcfg.n_experts, slots=mcfg.top_k)
        first = first or (want, (time.perf_counter() - t0) * 1e3)
        if not torch.equal(idx.reshape(want.shape).to(want.dtype), want):
            raise AssertionError(f"{name}: the kchoice launch differs from "
                                 f"kchoice_ref(slots={mcfg.top_k})")
    return first


def decode_routing_gate(torch, mcfg, logits, full, dec_routes,
                        fwd_routes) -> str:
    """Decode under the top-k router against the teacher-forced forward,
    token by token. A token whose experts in every layer equal the
    forward's: its logits within DECODE_TOL (relative L2) of the
    forward's, its next token equal outside near ties. A token whose
    experts differ in some layer: in the first such layer the forward's
    router had a near tie at the top-k cut (its k-th and (k+1)-th
    probabilities within DECODE_TOL of each other, relative): bf16
    rounding of the layer's input decides such a tie, and every later
    layer then sees another input. logits, full [B, n, V]; dec_routes the
    decode's routings (step-major, then layer), fwd_routes[b][layer] the
    forward's (logits, ids) at the decode's positions. Returns a summary;
    raises on a breach."""
    B, n = logits.shape[:2]
    n_layers = len(fwd_routes[0])
    k = mcfg.top_k
    flipped, worst = 0, 0.0
    for b in range(B):
        for t in range(n):
            first = None
            for layer in range(n_layers):
                f_lg, f_idx = fwd_routes[b][layer]
                d_idx = dec_routes[t * n_layers + layer][2][b]
                if not torch.equal(f_idx[t].sort().values,
                                   d_idx.sort().values):
                    first = layer
                    break
            if first is None:
                e = rel_l2(logits[b, t], full[b, t])
                worst = max(worst, e)
                top2 = full[b, t].topk(2).values
                tie = float(top2[0] - top2[1]) < 2e-2 * abs(float(top2[0]))
                if e > DECODE_TOL or (not tie and int(logits[b, t].argmax())
                                      != int(full[b, t].argmax())):
                    raise AssertionError(
                        f"mixtral decode (topk), row {b} step {t}: routed "
                        f"as the forward, logits rel L2 {e:.3e} (limit "
                        f"{DECODE_TOL}) or another next token")
                continue
            flipped += 1
            probs = torch.softmax(fwd_routes[b][first][0][t].float(), -1)
            top = probs.topk(k + 1).values
            if float(top[k - 1] - top[k]) > DECODE_TOL * float(top[k - 1]):
                raise AssertionError(
                    f"mixtral decode (topk), row {b} step {t}: layer "
                    f"{first} routed otherwise than the forward without a "
                    f"near tie ({top.tolist()})")
    return (f"{B * n - flipped} of {B * n} tokens routed as the forward in "
            f"every layer, their logits within {worst:.4e} (limit "
            f"{DECODE_TOL}); {flipped} routed otherwise first at a near tie "
            f"of the router")


def expert_share(torch, idx, E: int) -> float:
    """The largest expert's share of a routing's picks."""
    return float(torch.bincount(idx.reshape(-1).long(), minlength=E).max()
                 / idx.numel())


@contextlib.contextmanager
def first_moe_input(store: list):
    """Keep the input of the first MoE block a forward runs in ``store``;
    the block itself is unchanged."""
    from repro_torch.models import transformer as TR
    moe_apply = TR.moe_apply

    def keep(p, mcfg, x):
        if not store:
            store.append(x)
        return moe_apply(p, mcfg, x)
    TR.moe_apply = keep
    try:
        yield
    finally:
        TR.moe_apply = moe_apply


@contextlib.contextmanager
def recorded_kv(store: list):
    """Keep each attend_train call's k and v (one layer's, [B, S, Kv, D])
    in ``store``; the call is unchanged."""
    from repro_torch.models import attention as A
    qkv = A._qkv

    def keep(p, cfg, x, positions):
        q, k, v = qkv(p, cfg, x, positions)
        if x.shape[1] > 1:
            store.append((k, v))
        return q, k, v
    A._qkv = keep
    try:
        yield
    finally:
        A._qkv = qkv


def moe_cell(torch, dev) -> dict:
    """mixtral-8x7b at full width, MOE_LAYERS of its 32 layers (random
    bf16 weights from SEED), under the config's top-k router and under
    irli_kchoice (one kchoice launch a layer, slots 2): the prefill at
    [1, MOE_SEQ] (the 4096-token window masks real keys), every kchoice
    routing bit-equal to kchoice_ref(slots=2), the MoE output of the
    kernel-routed block bit-equal to the plain-routed one; decode at B =
    DECODE_B over a ring of 4096, 16 steps across pos 4096 (the ring
    wraps), the ring filled with the forward's K and V of positions 0..MOE_POS
    - 1, held to the teacher-forced forward (run a row at a time at
    capacity E / top_k, where no token is dropped) under top-k; _moe_rows
    at [2, 4096] with ffn_chunk 4096 against per-row routing. Then
    llama4-maverick's MoE block alone at full width (128 experts, top-1,
    a shared expert) on a [1, 2048] bf16 activation under both routers,
    kchoice at E = 128. Returns the launches, the router's kernel and
    plain times and the numbers."""
    import dataclasses

    from repro_torch.configs.llama4_maverick import CONFIG as LLAMA4
    from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.kchoice.ref import dependence_depth
    from repro_torch.launch.steps import build_lm_decode, build_lm_prefill
    from repro_torch.models import moe as MOE
    from repro_torch.models.module import param_bytes, param_count
    from repro_torch.models.transformer import (_logits, init_cache,
                                                lm_backbone, lm_init)
    from repro_torch.core.topk import topk_stable

    t_cell = time.perf_counter()
    log(f"moe cell: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"on the card before it")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = dataclasses.replace(MIXTRAL, n_layers=MOE_LAYERS)
    cfgs = {r: dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, router=r)) for r in ("topk", "irli_kchoice")}
    t0 = time.perf_counter()
    model = lm_init(base, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"mixtral-8x7b: {base.n_layers} of 32 layers, d {base.d_model}, "
        f"{base.n_heads} heads over {base.n_kv_heads} x {base.head_dim}, "
        f"SWA window {base.window}, {base.moe.n_experts} experts top-"
        f"{base.moe.top_k} of d_ff {base.moe.d_ff}: {param_count(model)} "
        f"params ({param_bytes(model) / 1e9:.2f} GB bf16), init "
        f"{time.perf_counter() - t0:.2f} s")
    launches, out, routes = {}, {}, []
    toks = torch.randint(0, base.vocab, (1, MOE_SEQ), generator=gen,
                         device=dev)
    xs = []
    for r, cfg in cfgs.items():
        step = build_lm_prefill(cfg)
        name = f"mixtral prefill [1, {MOE_SEQ}] ({r})"
        torch.cuda.synchronize()
        reset_launches()
        with recorded_routes(routes), first_moe_input(xs):
            out[r] = step(model, {"tokens": toks})
        torch.cuda.synchronize()
        got = {k: c for k, c in LAUNCHES.items() if c}
        want = {"kchoice": base.n_layers} if r == "irli_kchoice" else {}
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        launches[name] = got.get("kchoice", 0)
        if not bool(torch.isfinite(out[r]["logits"]).all()):
            raise AssertionError(f"{name}: non-finite logits")
        ms = time_ms(torch, lambda: step(model, {"tokens": toks}), n=2,
                     warmup=1)
        log(f"{name}: {ms:.4f} ms ({MOE_SEQ / ms * 1e3:.1f} tokens/s), next "
            f"token {out[r]['next_token'].tolist()}")
        if r == "irli_kchoice":
            traced, split, n_k, n_kern = device_split(
                torch, lambda: step(model, {"tokens": toks}),
                ("kchoice_kernel",), "kchoice (the router)")
            log(f"{name}: one traced prefill (torch.profiler), device time "
                f"{traced:.4f} ms, {n_k} kchoice of {n_kern} kernels; by "
                f"group: " + "; ".join(f"{g} {t:.4f} ms ({t / traced:.1%})"
                                      for g, t in list(split.items())[:10]))
    plain_walk = router_check(torch, "mixtral prefill", routes,
                              cfgs["irli_kchoice"].moe)
    shares = [expert_share(torch, idx, base.moe.n_experts)
              for r, _, idx in routes if r == "irli_kchoice"]
    # the same layer-0 block (its prefill input), routed by the kernel and
    # by the plain walk
    mk = cfgs["irli_kchoice"].moe
    lp = model["layers"][0]["moe"]
    with torch.inference_mode():
        yk, _ = MOE.moe_apply(lp, mk, xs[0])
        with plain_router():
            yp, _ = MOE.moe_apply(lp, mk, xs[0])
        yt, _ = MOE.moe_apply(lp, cfgs["topk"].moe, xs[0])
    if not torch.equal(yk, yp):
        raise AssertionError("mixtral MoE block: the kernel-routed output "
                             "differs from the plain-routed one")
    # the router on its own at the prefill's shape: kernel, plain, bound
    logits0 = next(lg for r, lg, _ in routes if r == "irli_kchoice")
    K = max(mk.router_k_choices, mk.top_k)
    topi = topk_stable(torch.softmax(logits0.float(), -1), K)[1]
    topi = topi[None].to(torch.int32).contiguous()
    order = torch.arange(topi.shape[1], dtype=torch.int32,
                         device=dev)[None].contiguous()
    k_ms = time_ms(torch, lambda: kops.kchoice(topi, order, B=mk.n_experts,
                                               slots=mk.top_k), n=10)
    picks, p_ms = plain_walk
    depth = int(dependence_depth(topi, order, picks, B=mk.n_experts)[0])
    link = kops.step_cycles(dev)
    clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    r_bound = depth * link / clock * 1e3
    log(f"mixtral router (irli_kchoice, slots {mk.top_k}, K {K}, E "
        f"{mk.n_experts}, T {topi.shape[1]}): {len(shares)} routings "
        f"bit-equal to kchoice_ref; the layer-0 block's output routed by "
        f"the kernel bit-equal to the plain-routed one; largest expert's "
        f"share of the picks by layer {[round(s, 4) for s in shares]} (top-"
        f"k on layer 0's input: {expert_share(torch, topk_stable(torch.softmax(logits0.float(), -1), mk.top_k)[1], mk.n_experts):.4f}, "
        f"a fair share {1 / mk.n_experts:.4f}); the kchoice launch alone "
        f"{k_ms:.4f} ms, kchoice_ref (host walk) {p_ms:.1f} ms; dependence "
        f"depth {depth} of {picks.numel()} picks x {link:.2f} clocks a link "
        f"at {clock / 1e9:.3f} GHz -> bound {r_bound:.4f} ms")
    del yk, yp, yt, xs, out
    routes.clear()
    # decode across pos 4096: the ring filled from the teacher-forced forward
    B, n, P = DECODE_B, DECODE_STEPS, MOE_POS
    ctx = 2 * base.window
    dtoks = torch.randint(0, base.vocab, (B, P + n), generator=gen,
                          device=dev)
    nodrop = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k))
    full, kv, fwd_routes = [], [], []
    with torch.inference_mode():
        for b in range(B):
            store, rstore = [], []
            with recorded_kv(store), recorded_routes(rstore):
                h, _ = lm_backbone(model, nodrop, dtoks[b:b + 1])
            full.append(_logits(model, nodrop, h[:, P:])[0])
            kv.append(store)
            fwd_routes.append([(lg[P:], idx[P:]) for _, lg, idx in rstore])
    full = torch.stack(full)                                   # [B, n, V]
    dec = {}
    for r, cfg in cfgs.items():
        caches = init_cache(cfg, B, ctx, device=dev)
        Sc = caches[0]["k"].shape[1]
        for layer, c in enumerate(caches):
            for b in range(B):
                k, v = kv[b][layer]
                c["k"][b, :P] = k[0, :P]
                c["v"][b, :P] = v[0, :P]
        step = build_lm_decode(cfg, ctx)
        logits = []
        torch.cuda.synchronize()
        reset_launches()
        with recorded_routes(routes):
            for t in range(n):
                o = step(model, {"token": dtoks[:, P + t], "caches": caches,
                                 "pos": torch.full((B,), P + t, device=dev)})
                logits.append(o["logits"])
        torch.cuda.synchronize()
        got = {k: c for k, c in LAUNCHES.items() if c}
        want = {"kchoice": base.n_layers * n} if r == "irli_kchoice" else {}
        if got != want:
            raise AssertionError(f"mixtral decode ({r}) launched {got}, "
                                 f"expected {want}")
        launches[f"mixtral decode ({r})"] = got.get("kchoice", 0)
        logits = torch.stack(logits, 1)                        # [B, n, V]
        errs = [rel_l2(logits[:, t], full[:, t]) for t in range(n)]
        dec[r] = errs
        if r == "topk":
            held = decode_routing_gate(torch, cfg.moe, logits, full, routes,
                                       fwd_routes)
        else:
            router_check(torch, "mixtral decode", routes, cfg.moe)
        routes.clear()
        batch = {"token": dtoks[:, P + n - 1], "caches": caches,
                 "pos": torch.full((B,), P + n - 1, device=dev)}
        step_ms = time_ms(torch, lambda: step(model, batch), n=10, warmup=2)
        gate = (held if r == "topk" else "not a gate: the k-choice loads "
                "run over the whole block in the forward, over one step in "
                "decode")
        log(f"mixtral decode ({r}, B {B}, ring of {Sc} slots, positions "
            f"{P}..{P + n - 1}): logits rel L2 against the teacher-forced "
            f"forward max {max(errs):.4e} over the step's rows ({gate}); "
            f"{step_ms:.4f} ms a step, {B / step_ms * 1e3:.1f} tokens/s")
        del caches, batch
    del full, kv
    # _moe_rows: the per-row path at [2, MOE_ROWS_T], ffn_chunk MOE_ROWS_T
    x = torch.randn((2, MOE_ROWS_T, base.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    half = MOE_ROWS_T // 2
    for r in ("topk", "irli_kchoice"):
        mr = dataclasses.replace(cfgs[r].moe, ffn_chunk=MOE_ROWS_T)
        rows, single = [], []
        reset_launches()
        with torch.inference_mode():
            logits = MOE.L.dense_apply(lp["router"], x)
            y, _ = MOE.moe_apply(lp, mr, x)
        got = LAUNCHES["kchoice"]
        with torch.inference_mode():
            for s0 in range(0, MOE_ROWS_T, half):
                lg = logits[:, s0:s0 + half]
                rows.append(MOE._route(lg, mr)[1])
                single.append(torch.stack([MOE._route(lg[b], mr)[1]
                                           for b in range(2)]))
        if not all(torch.equal(a, b) for a, b in zip(rows, single)):
            raise AssertionError(f"_moe_rows ({r}): the batched routing "
                                 f"differs from the per-row one")
        if r == "irli_kchoice" and got != 2:
            raise AssertionError(f"_moe_rows launched {got} kchoice, not 2")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"_moe_rows ({r}): non-finite output")
        launches[f"mixtral _moe_rows ({r})"] = got
    log(f"mixtral _moe_rows at [2, {MOE_ROWS_T}] (ffn_chunk {MOE_ROWS_T}: "
        f"2 chunks of [2, {half}]): the batched routing equals each row's "
        f"alone under both routers (one kchoice launch a chunk, G = 2)")
    del model, lp, x, y, logits, rows, single
    torch.cuda.empty_cache()
    # llama4-maverick's MoE block at full width
    lm = LLAMA4.moe
    t0 = time.perf_counter()
    p = MOE.moe_init(gen, lm, torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = param_bytes(p)
    x = torch.randn((1, LLAMA4_T, lm.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    ys = {}
    for r in ("topk", "irli_kchoice"):
        mr = dataclasses.replace(lm, router=r)
        reset_launches()
        with recorded_routes(routes), torch.inference_mode():
            ys[r], _ = MOE.moe_apply(p, mr, x)
        torch.cuda.synchronize()
        got = LAUNCHES["kchoice"]
        if got != (1 if r == "irli_kchoice" else 0):
            raise AssertionError(f"llama4 MoE block ({r}) launched {got} "
                                 f"kchoice")
        launches[f"llama4 MoE block ({r})"] = got
        if not bool(torch.isfinite(ys[r]).all()):
            raise AssertionError(f"llama4 MoE block ({r}): non-finite")
        ms = time_ms(torch, lambda: MOE.moe_apply(p, mr, x), n=5)
        with torch.inference_mode():
            lg = MOE.L.dense_apply(p["router"], x.reshape(-1, lm.d_model))
            idx = MOE._route(lg, mr)[1]
        log(f"llama4 MoE block ({r}, {lm.n_experts} experts top-1 + shared, "
            f"[1, {LLAMA4_T}]): {ms:.4f} ms (the weights {nbytes / 1e9:.2f} GB read once: "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), largest expert's "
            f"share {expert_share(torch, idx, lm.n_experts):.4f} (capacity "
            f"{MOE._capacity(mr, LLAMA4_T)} an expert of {LLAMA4_T} "
            f"tokens)")
    router_check(torch, "llama4 MoE block", routes, dataclasses.replace(
        lm, router="irli_kchoice"))
    with torch.inference_mode(), plain_router():
        yp, _ = MOE.moe_apply(p, dataclasses.replace(
            lm, router="irli_kchoice"), x)
    if not torch.equal(ys["irli_kchoice"], yp):
        raise AssertionError("llama4 MoE block: the kernel-routed output "
                             "differs from the plain-routed one")
    log(f"llama4 MoE block: {nbytes / 1e9:.2f} GB bf16 (init "
        f"{time.perf_counter() - t0:.2f} s), the kchoice routing at E = "
        f"{lm.n_experts} "
        f"bit-equal to kchoice_ref, the kernel-routed output bit-equal to "
        f"the plain-routed one; moe cell {time.perf_counter() - t_cell:.1f} "
        f"s")
    del p, x, ys, yp
    torch.cuda.empty_cache()
    return {"launches": launches, "decode": dec}


def baselines_phase(torch, dev, run, idx) -> dict:
    """The paper's partition baselines (core/baselines.py) on the fit
    cell's data (FIT_L labels at the deep1b widths, its Q held-out queries
    and their exact top-K): k-means and LSH at B buckets and the random
    partition, each through its query -> bucket rule (centroid_top_buckets,
    lsh_top_buckets, random buckets) -> candidates_from_partition ->
    recall_of_mask at m = 1, 4, 16, beside the fitted index's candidates
    (its top-m probe of R reps, gathered); balanced k-means at
    BALANCED_L labels and BALANCED_B buckets (its host walk)."""
    import numpy as np

    from repro_torch.core import baselines as BL
    from repro_torch.core.query import gather_members, probe_buckets

    t_phase = time.perf_counter()
    base, fq, gt = run["base"], run["queries"], run["gt"]
    Lb = base.shape[0]
    t0 = time.perf_counter()
    ka, kc = BL.kmeans_partition(base, B, seed=SEED)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    la, planes = BL.lsh_partition(base, B, seed=SEED)
    ra = BL.random_partition(Lb, B, SEED, device=dev)
    rng = np.random.default_rng(SEED)
    rules = {
        "kmeans": (ka, lambda m: BL.centroid_top_buckets(fq, kc, m)),
        "lsh": (la, lambda m: BL.lsh_top_buckets(fq, planes, B, m)),
        "random": (ra, lambda m: torch.from_numpy(rng.integers(
            0, B, (fq.shape[0], m)).astype(np.int32)).to(dev)),
    }
    out = {}
    for m in (1, 4, 16):
        row = {}
        for name, (assign, rule) in rules.items():
            mask = BL.candidates_from_partition(assign, rule(m), Lb)
            row[name] = (BL.recall_of_mask(mask, gt),
                         float(mask.sum(1).float().mean()))
        cands = gather_members(idx.index.members,
                               probe_buckets(idx.params, fq, m))
        mask = torch.zeros((fq.shape[0], Lb + 1), dtype=torch.bool,
                           device=dev)
        mask.scatter_(1, torch.where(cands >= 0, cands, Lb).long(), True)
        row["irli (fitted)"] = (BL.recall_of_mask(mask[:, :Lb], gt),
                                float(mask[:, :Lb].sum(1).float().mean()))
        out[m] = row
        log(f"baselines at m = {m} (B {B}, L {Lb}, Q {fq.shape[0]}): "
            + "; ".join(f"{n} recall@{K} {r:.4f} with {c:.1f} candidates a "
                        f"query" for n, (r, c) in row.items()))
    sub = base[:BALANCED_L]
    t0 = time.perf_counter()
    ba, bc = BL.balanced_kmeans_partition(sub, BALANCED_B, seed=SEED)
    b_s = time.perf_counter() - t0
    load = torch.bincount(ba.long(), minlength=BALANCED_B)
    if int(load.max()) > -(-BALANCED_L // BALANCED_B):
        raise AssertionError(f"balanced k-means: a bucket holds "
                             f"{int(load.max())} labels")
    form = "blocked" if Lb * B * base.shape[1] >= 2e8 else "direct"
    log(f"baselines: k-means at B {B} over {Lb} labels (25 Lloyd "
        f"iterations, the {form} distance form) {k_s:.2f} s; balanced "
        f"k-means at L {BALANCED_L}, B {BALANCED_B} (25 iterations, the host "
        f"walk) {b_s:.2f} s, loads {int(load.min())}..{int(load.max())} "
        f"(capacity {-(-BALANCED_L // BALANCED_B)}); the fitted index's "
        f"search recall@{K} {run['recall'][1]:.4f}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


@contextlib.contextmanager
def plain_bags():
    """dien_apply's history sum through the plain version (ref.py: no
    launch) instead of the kernel; only for the comparison of a whole
    forward."""
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import recsys
    kernel = recsys.bag_lookup_reduce
    recsys.bag_lookup_reduce = embedding_bag_ref
    try:
        yield
    finally:
        recsys.bag_lookup_reduce = kernel


def bag_bound(torch, ids, table) -> tuple[float, str, int]:
    """embedding_bag's least time on these inputs: ids and weights read
    once, each distinct table row it touches read once, the output written
    once, at the memory rate -> (ms, "bytes", distinct rows). Its 2·N·P·D
    flops are far below the fp32 peak."""
    from repro_torch.kernels.embedding_bag import ops as eops
    rows = int(torch.unique(ids[ids >= 0]).numel())
    nbytes = eops.cost(*ids.shape, *table.shape,
                       itemsize=table.element_size(), rows=rows)["bytes"]
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", rows


def close_err(torch, name, got, want) -> float:
    """|got - want| <= TOL + TOL·|want| everywhere, all finite, or raise
    -> max |got - want|."""
    d = (got.float() - want.float()).abs()
    bad = int((d > TOL + TOL * want.float().abs()).sum())
    err = float(d.max()) if d.numel() else 0.0
    log(f"{name}: max |kernel - plain| {err:.3e}, {bad} of {d.numel()} "
        f"outside {TOL:g} + {TOL:g}·|plain|")
    if bad or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: {bad} values outside the tolerance "
                             f"or not finite")
    return err


def recsys_cell(torch, dev, smi) -> dict:
    """The recsys cell: DIEN at configs/dien.CONFIG's full width (random
    weights from SEED) served through build_ctr_serve at the reference's
    serve_p99 and serve_bulk batches (behavior_stream, seed SEED): two
    embedding_bag launches a forward and no other kernel, the kernel
    against its plain version on each batch's ids and mask for both
    tables, the forward against itself with the plain history sum, the
    warm forward's time, samples/s, peak memory and device time by op;
    then the kernel alone at serve_bulk's item shape beside its bound, the
    plain version and F.embedding_bag. Returns launches, error, times and
    bound."""
    import torch.nn.functional as F

    from repro_torch.configs.dien import BATCHES, CONFIG, apply
    from repro_torch.data.synthetic import behavior_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.steps import build_ctr_serve
    from repro_torch.models.module import param_bytes, param_count
    from repro_torch.models.recsys import dien_init

    t0 = time.perf_counter()
    params = dien_init(CONFIG, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"dien: embed {CONFIG.embed_dim}, seq {CONFIG.seq_len}, gru "
        f"{CONFIG.gru_dim}, mlp {CONFIG.mlp}, item vocab "
        f"{CONFIG.item_vocab}, category vocab {CONFIG.cate_vocab}: "
        f"{param_count(params)} params ({param_bytes(params) / 1e6:.1f} MB "
        f"fp32), init {time.perf_counter() - t0:.2f} s")
    step = build_ctr_serve(apply)
    tables = {"item": params["item_emb"]["table"],
              "category": params["cate_emb"]["table"]}
    attrs = eops.kernel_attrs()
    plan = eops.bag_plan(CONFIG.embed_dim, torch.float32)
    log(f"embedding_bag attrs: {attrs['registers']} registers, "
        f"{attrs['spill_bytes']} spill bytes a thread (the most of its "
        f"instantiations); plan at D={CONFIG.embed_dim} fp32 {plan}")
    if attrs["spill_bytes"]:
        raise AssertionError(f"embedding_bag spills registers: {attrs}")
    for dt in (torch.float32, torch.bfloat16):
        if eops.plan_export(CONFIG.embed_dim, dt) != eops.bag_plan(
                CONFIG.embed_dim, dt):
            raise AssertionError(f"embedding_bag's plan at {dt}: C side "
                                 f"{eops.plan_export(CONFIG.embed_dim, dt)}")
    extra = dict(attrs)
    launches, err = {}, 0.0
    for cell, bsz in BATCHES.items():
        name = f"recsys {cell} [{bsz}]"
        t0 = time.perf_counter()
        host = next(behavior_stream(bsz, CONFIG.seq_len, CONFIG.item_vocab,
                                    CONFIG.cate_vocab, seed=SEED))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
        del host
        torch.cuda.synchronize()
        ids = {"item": batch["hist_items"], "category": batch["hist_cates"]}
        mask = batch["hist_mask"]
        log(f"{name}: batch made and moved in "
            f"{time.perf_counter() - t0:.2f} s; "
            f"{int(torch.unique(ids['item']).numel())} distinct history "
            f"items of {ids['item'].numel()}")
        for t, table in tables.items():
            got = eops.embedding_bag(ids[t], mask, table)
            want = embedding_bag_ref(ids[t], mask, table)
            torch.cuda.synchronize()
            err = max(err, close_err(
                torch, f"embedding_bag at {name}, {t} table "
                f"{tuple(table.shape)}", got, want))
            del got, want
        if cell == "serve_p99":
            ids_p, table = ids["item"], tables["item"]
            extra["serve_p99_ms"] = time_ms(
                torch, lambda: eops.embedding_bag(ids_p, mask, table), n=50)
            extra["serve_p99_plain_ms"] = time_ms(
                torch, lambda: embedding_bag_ref(ids_p, mask, table), n=20)
            extra["serve_p99_device_ms"] = device_ms(
                torch, lambda: eops.embedding_bag(ids_p, mask, table))
            safe_p = ids_p.clamp_min(0)
            w_p = torch.where(ids_p >= 0, mask, torch.zeros_like(mask))
            extra["serve_p99_library_ms"] = time_ms(
                torch, lambda: F.embedding_bag(
                    safe_p, table, per_sample_weights=w_p, mode="sum"),
                n=50)
            p99_bound, _, p99_rows = bag_bound(torch, ids_p, table)
            extra["serve_p99_bound_ms"] = p99_bound
            log(f"embedding_bag at {name}, item table, ids "
                f"{tuple(ids_p.shape)} ({p99_rows} distinct rows): bound "
                f"{p99_bound:.4f} ms (bytes); kernel "
                f"{extra['serve_p99_ms']:.4f} ms (device time "
                f"{extra['serve_p99_device_ms']:.4f} ms), plain (ref.py) "
                f"{extra['serve_p99_plain_ms']:.4f} ms, library "
                f"(F.embedding_bag, per_sample_weights) "
                f"{extra['serve_p99_library_ms']:.4f} ms [{smi}]")
            del safe_p, w_p
        torch.cuda.synchronize()
        reset_launches()
        prob = step(params, batch)["prob"]
        torch.cuda.synchronize()
        got = {n: c for n, c in LAUNCHES.items() if c}
        if got != {"embedding_bag": 2}:
            raise AssertionError(f"{name}: the forward launched {got}, not "
                                 f"two embedding_bag")
        launches[name] = got["embedding_bag"]
        if prob.shape != (bsz,) or prob.dtype != torch.float32 \
                or not bool(((prob >= 0) & (prob <= 1)).all()):
            raise AssertionError(f"{name}: prob {tuple(prob.shape)} "
                                 f"{prob.dtype} not in [0, 1]")
        with plain_bags():
            plain = step(params, batch)["prob"]
        close_err(torch, f"{name}: prob, kernel vs plain history sum", prob,
                  plain)
        del plain
        n_runs = 10 if bsz <= 4096 else 3
        fwd_ms = time_ms(torch, lambda: step(params, batch), n=n_runs,
                         warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        step(params, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        traced, split, n_bag, n_kern = device_split(
            torch, lambda: step(params, batch), ("embedding_bag_kernel",),
            "embedding_bag (embedding_bag_kernel)")
        if n_bag != 2:
            raise AssertionError(f"{name}: the traced forward ran {n_bag} "
                                 f"embedding_bag kernels, not 2")
        log(f"{name}: forward {fwd_ms:.4f} ms ({bsz / fwd_ms * 1e3:.1f} "
            f"samples/s), peak device memory above the weights and inputs "
            f"{peak / 1e9:.3f} GB [{smi}]")
        log(f"{name}: one traced forward (torch.profiler), {n_kern} "
            f"kernels ({fwd_ms / n_kern * 1e3:.2f} us of the forward a "
            f"kernel), device time "
            f"{traced:.4f} ms ({traced / fwd_ms:.1%} of the forward's, so "
            f"the device idles {max(0.0, 1 - traced / fwd_ms):.1%}); by "
            f"group: " + "; ".join(f"{n} {t:.4f} ms ({t / traced:.1%})"
                                   for n, t in split.items()))
        del prob
        if cell != "serve_bulk":
            del batch, ids, mask
            torch.cuda.empty_cache()
    # the kernel alone at serve_bulk's item shape
    times, bounds = {}, {}
    for t in ("item", "category"):
        table = tables[t]
        ids_t = ids[t]
        safe = ids_t.clamp_min(0)
        w = torch.where(ids_t >= 0, mask, torch.zeros_like(mask))
        bms, by, rows = bag_bound(torch, ids_t, table)
        k_ms = time_ms(torch, lambda: eops.embedding_bag(ids_t, mask, table))
        k_dev = device_ms(torch, lambda: eops.embedding_bag(ids_t, mask,
                                                            table))
        extra[f"{t}_device_ms"] = k_dev
        p_ms = time_ms(torch, lambda: embedding_bag_ref(ids_t, mask, table))
        l_ms = time_ms(torch, lambda: F.embedding_bag(
            safe, table, per_sample_weights=w, mode="sum"))
        log(f"embedding_bag at serve_bulk, {t} table {tuple(table.shape)}, "
            f"ids {tuple(ids_t.shape)} ({rows} distinct rows): bound "
            f"{bms:.4f} ms ({by}); kernel {k_ms:.4f} ms (bound / kernel "
            f"{bms / k_ms:.1%}; device time {k_dev:.4f} ms), plain (ref.py) "
            f"{p_ms:.4f} ms, library "
            f"(F.embedding_bag, per_sample_weights) {l_ms:.4f} ms [{smi}]")
        times[t], bounds[t] = (k_ms, p_ms, l_ms), (bms, by)
    del params, batch, ids, mask, safe, w
    torch.cuda.empty_cache()
    extra.update(category_ms=times["category"][0],
                 category_bound_ms=bounds["category"][0])
    return {"launches": launches, "err": err, "times": times["item"],
            "bound": bounds["item"], "extra": extra}


def dist_check(torch, name, vals, ids, q, base, mask, k, metric="dot"):
    """distance_topk's output against its plain version on the same inputs:
    ids by irli_topk.ref.same_topm (the plain top-(k+1) gives the rows with
    a near tie at the k cut), finite values to TOL. -> max |err|."""
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.kernels.irli_topk.ref import same_topm
    rv, ri = distance_topk_ref(q, base, mask, k=min(k + 1, base.shape[0]),
                               metric=metric)
    fin = torch.isfinite(rv[:, :k])
    if not torch.equal(torch.isfinite(vals), fin):
        raise AssertionError(f"distance_topk {name}: other finite slots "
                             f"than the plain version")
    zero = lambda v: torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    ri = torch.where(torch.isfinite(rv), ri, torch.full_like(ri, -1))
    cut, order = same_topm(zero(vals), ids, zero(rv), ri, TOL)
    err = float((zero(vals) - zero(rv[:, :k])).abs().max())
    log(f"distance_topk {name} q {tuple(q.shape)} base {tuple(base.shape)} "
        f"k={k} {metric}: max |err| {err:.3g}; {cut} of {len(q)} rows "
        f"exempt (near tie at the k cut), {order} in another order among "
        f"near values")
    return err


@contextlib.contextmanager
def freq_rows_seen(seen: list):
    """Within it, every freq_topc launch also appends its (candidates, C)
    to ``seen``; the launch itself is unchanged."""
    from repro_torch.kernels.freq_topc import ops as fops
    launch = fops.freq_topc

    def capture(cands, *, C):
        seen.append((cands, C))
        return launch(cands, C=C)

    fops.freq_topc = capture
    try:
        yield seen
    finally:
        fops.freq_topc = launch


def stream_freq(torch, seen) -> dict:
    """freq_topc at the streaming search's own gathered candidates, before
    compaction (C0 = R·m·(max_load + delta_len) = 65,280 a query: a cluster
    of two blocks a row) and after it: each held bit-equal to the plain
    version, then timed beside the plain version and the byte bound (the
    ids read once, the ids and counts written once)."""
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    out = {}
    for key, (cands, C) in zip(("stream", "stream_compacted"), seen):
        ids, cnt = fops.freq_topc(cands, C=C)
        rids, rcnt = freq_topc_ref(cands, C=C)
        if not (torch.equal(ids, rids) and torch.equal(cnt, rcnt)):
            raise AssertionError(f"freq_topc differs from its plain version "
                                 f"at the {key} search's candidates")
        plan = fops.radix_plan(cands.shape[1], int(cands.max()))
        ms = time_ms(torch, lambda: fops.freq_topc(cands, C=C), n=10)
        plain = time_ms(torch, lambda: freq_topc_ref(cands, C=C), n=5)
        b = bound(0, cands.numel() * 4 + cands.shape[0] * C * 8)
        log(f"freq_topc at the {key} search's candidates "
            f"{tuple(cands.shape)} C={C}: bit-exact; plan {plan}; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b[0]:.4f} ms "
            f"({b[1]})")
        out.update({f"{key}_shape": list(cands.shape), f"{key}_ms": ms,
                    f"{key}_plain_ms": plain, f"{key}_bound_ms": b[0]})
    return out


def stream_cell(torch, dev, idx, corpus, queries, plain_search, agree):
    """The stream cell: MutableIRLIIndex over the serve cell's index (L =
    2,000,000, capacity 2·L, delta_len 208, int8 store) at the irli-deep1b
    widths. Its path, counters from 0: 16 insert batches of 4096 (one
    irli_topk and one kchoice launch each), 100,000 deletes, a search
    (mode="auto" -> "mega", served by the compact kernels: the snapshot
    carries delta and tombstone state), compaction, the search again, the
    exact oracle (one distance_topk launch). Then the checks against the
    plain versions, the invariants and the times. Returns the launches,
    records, times and bounds."""
    import dataclasses

    from repro_torch.core.search_api import PipelineCache, SearchParams
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.distance_topk import ops as dops
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.stream import MutableIRLIIndex

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    new = torch.randn((N_INSERT, D), generator=gen, device=dev)
    new /= new.norm(dim=1, keepdim=True)
    dead = torch.cat([
        torch.randperm(L, generator=gen, device=dev)[:N_DEL_BASE],
        L + torch.randperm(N_INSERT, generator=gen, device=dev)[:N_DEL_NEW]])
    midx = MutableIRLIIndex(idx, corpus, store_dtype="int8")
    torch.cuda.synchronize()
    s0 = midx.snapshot
    if midx.capacity != 2 * L or s0.delta.members.shape[2] != DELTA_LEN:
        raise AssertionError(f"stream cell: capacity {midx.capacity}, "
                             f"delta_len {s0.delta.members.shape[2]}")
    log(f"stream setup: {time.perf_counter() - t0:.2f} s; capacity "
        f"{midx.capacity}, delta [R, B, DL] {tuple(s0.delta.members.shape)}"
        f", members {tuple(s0.members.shape)}, int8 store "
        f"{s0.store.nbytes() / 1e6:.0f} MB over {s0.vecs.shape[0]} rows")
    del s0
    sp = SearchParams(m=M, tau=TAU, k=K, store_dtype="int8")
    cache = PipelineCache()

    # ---- the stream path, counters from 0 ----
    torch.cuda.synchronize()
    reset_launches()
    batch_s, per_batch, ids = [], [], []
    for s in range(0, N_INSERT, INSERT_BATCH):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        ids.append(midx.insert(new[s:s + INSERT_BATCH]))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        per_batch.append({n: c - before[n] for n, c in LAUNCHES.items()
                          if c != before[n]})
    t0 = time.perf_counter()
    n_dead = midx.delete(dead)
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    seen = []                  # the candidates each search gathers
    t0 = time.perf_counter()
    with freq_rows_seen(seen):
        pre = midx.search(queries, sp, cache=cache)
        torch.cuda.synchronize()
    first_search_s = time.perf_counter() - t0
    snap = midx.snapshot
    t0 = time.perf_counter()
    midx.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    with freq_rows_seen(seen):
        post = midx.search(queries, sp, cache=cache)
    oracle = midx.exact_oracle(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    o_ids = oracle(queries)
    oracle_s = time.perf_counter() - t0
    o_peak = torch.cuda.max_memory_allocated() - mem0
    launches = {n: c for n, c in LAUNCHES.items() if c}

    n_batches = N_INSERT // INSERT_BATCH
    want = {"irli_topk": n_batches + 2, "kchoice": n_batches,
            "freq_topc": 2, "quant_rerank": 2, "distance_topk": 1}
    log(f"stream path launches {launches} (expected {want}); per insert "
        f"batch {per_batch[0]} (all {len(per_batch)} alike: "
        f"{all(b == per_batch[0] for b in per_batch)})")
    if launches != want or any(b != {"irli_topk": 1, "kchoice": 1}
                               for b in per_batch):
        raise AssertionError(f"the stream path launched {launches}, "
                             f"batches {per_batch}")
    new_ids = torch.cat(ids)
    if not torch.equal(new_ids.cpu(), torch.arange(
            L, L + N_INSERT, dtype=torch.int32)) or n_dead != len(dead):
        raise AssertionError(f"stream cell: inserted ids or deletes "
                             f"({n_dead}) off")
    if pre.mode != "mega" or post.mode != "mega":
        raise AssertionError(f"auto resolved {pre.mode!r}, {post.mode!r}")

    # ---- the checks ----
    base = dataclasses.replace(snap.store, exact=snap.vecs)
    plain, exempt, mcut = plain_search(
        sp, base, queries,
        (snap.params, snap.members, snap.delta.members, snap.tombstone))
    serr = agree("stream search (delta + tombstone state, compact kernels)",
                 (pre.ids, pre.scores, pre.n_candidates), plain, exempt,
                 mcut)
    del plain, base, snap
    same = (torch.equal(pre.ids, post.ids)
            and torch.equal(pre.scores, post.scores)
            and torch.equal(pre.n_candidates, post.n_candidates))
    log(f"compaction: the search after it equals the search before it bit "
        f"for bit: {same}")
    if not same:
        raise AssertionError("compaction changed the search's results")
    s = midx.snapshot
    n = s.n_total
    vecs, live = s.vecs[:n], ~s.tombstone[None, :n]
    liveq = live.expand(Q, n)
    o_ids = torch.from_numpy(o_ids).to(dev)
    for name, got in (("search", pre.ids), ("oracle", o_ids)):
        if bool(torch.isin(got.long(), dead).any()):
            raise AssertionError(f"the stream {name} returned a deleted id")
    vals, kids = dops.distance_topk(queries, vecs, liveq, k=K)
    if not torch.equal(kids, o_ids):
        raise AssertionError("the oracle's ids differ from its kernel's")
    derr = dist_check(torch, "exact oracle (stride-0 live mask)", vals, kids,
                      queries, vecs, live, K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    distance_topk_ref(queries, vecs, live, k=K)
    torch.cuda.synchronize()
    p_peak = torch.cuda.max_memory_allocated() - mem0
    table = Q * n * 4
    log(f"exact oracle (Q={Q}, {n} rows, {n - n_dead} live, k={K}): peak "
        f"device memory above its inputs {o_peak / 1e6:.2f} MB (kernel), "
        f"{p_peak / 1e9:.3f} GB (plain; its [Q, L] fp32 table alone is "
        f"{table / 1e9:.2f} GB)")
    if not o_peak < 85e6:
        raise AssertionError(f"the oracle peaked at {o_peak} B")
    hit = ((pre.ids[:, :, None] == o_ids[:, None, :])
           & (o_ids[:, None, :] >= 0)).any(-1).sum()
    rec = float(hit) / float((o_ids >= 0).sum())
    qs = queries[:Q_SMALL].contiguous()
    v2, i2 = dops.distance_topk(qs, vecs, live.expand(Q_SMALL, n), k=K,
                                metric="l2")
    derr = max(derr, dist_check(torch, f"l2 at Q={Q_SMALL}", v2, i2, qs,
                                vecs, live, K, "l2"))
    # rows too wide for a resident query tile (d > 288): its slices come
    # through the ring beside the corpus's; unit rows, as the corpus's
    unit = lambda *shape: torch.nn.functional.normalize(
        torch.randn(shape, generator=gen, device=dev), dim=1)
    wq, wb = unit(Q_SMALL, 768), unit(50_000, 768)
    every = torch.ones((1, 50_000), dtype=torch.bool, device=dev)
    v3, i3 = dops.distance_topk(wq, wb, every.expand(Q_SMALL, -1), k=K)
    derr = max(derr, dist_check(torch, "at d=768 (query tile streamed)", v3,
                                i3, wq, wb, every, K))
    del wq, wb, v3, i3
    alive = new_ids.to(dev)[~s.tombstone[new_ids.to(dev).long()]]
    sel = alive[torch.randperm(len(alive), generator=gen,
                               device=dev)[:Q]].long()
    own = midx.search(new[sel - L], sp, cache=cache)
    self_rate = float((own.ids[:, 0].long() == sel).float().mean())
    log(f"stream search recall@{K} against the exact oracle: {rec:.4f}; "
        f"{self_rate:.4f} of {Q} sampled live inserted vectors return "
        f"their own id at rank 0")
    if not self_rate >= 0.99:
        raise AssertionError(f"only {self_rate} of the inserted vectors "
                             f"find themselves")

    # ---- the times ----
    search_ms = time_ms(torch, lambda: midx.search(queries, sp, cache=cache),
                        n=5, warmup=1)
    freq = stream_freq(torch, seen)
    del seen
    oracle_ms = time_ms(torch, lambda: oracle(queries), n=5, warmup=1)
    dist_ms = time_ms(torch, lambda: dops.distance_topk(queries, vecs, liveq,
                                                        k=K), n=10)
    dist_plain = time_ms(torch, lambda: distance_topk_ref(
        queries, vecs, live, k=K), n=3, warmup=1)

    def library():
        sim = torch.matmul(queries, vecs.T)
        sim.masked_fill_(~live, -torch.inf)
        return torch.topk(sim, K, dim=1)

    dist_lib = time_ms(torch, library, n=3, warmup=1)
    dist_alone = time_ms(torch, lambda: torch.mm(queries, vecs.T), n=5,
                         warmup=1)
    dist_cost = dops.cost(Q, n, D, K)
    dist_bound = bound(dist_cost["flops"], dist_cost["bytes"])
    log(f"stream stages: insert batch of {INSERT_BATCH} median "
        f"{statistics.median(batch_s) * 1e3:.2f} ms (first "
        f"{batch_s[0] * 1e3:.2f} ms, all {sum(batch_s):.3f} s), delete of "
        f"{len(dead)} {delete_s * 1e3:.2f} ms, first search "
        f"{first_search_s * 1e3:.2f} ms, compaction {compact_s * 1e3:.2f} "
        f"ms, search {search_ms:.4f} ms, exact oracle {oracle_ms:.4f} ms "
        f"(first call {oracle_s * 1e3:.2f} ms)")
    log(f"distance_topk at the oracle (Q={Q}, L={n}, d={D}, k={K}): "
        f"{2 * Q * n * D / 1e12:.4f} TFLOP, {n * D * 4 / 1e9:.3f} GB -> "
        f"bound {dist_bound[0]:.4f} ms ({dist_bound[1]}); kernel "
        f"{dist_ms:.4f} ms ({2 * Q * n * D / dist_ms / 1e9:.1f} TFLOP/s), "
        f"plain {dist_plain:.4f} ms, library (torch.matmul + masked_fill_ "
        f"+ torch.topk) {dist_lib:.4f} ms")
    attrs = dops.kernel_attrs(D, K)
    log(f"distance_topk footprint at d={D}, k={K}: {attrs['smem_bytes']} B "
        f"of shared memory a block (lists in shared memory: "
        f"{bool(attrs['lists_in_smem'])}), {attrs['blocks_per_sm']} blocks "
        f"an SM, {dops.splits(Q, n, K, dev, D)} splits; the l2 kernel "
        f"{attrs['l2_registers']} registers, {attrs['l2_spill_bytes']} "
        f"spill bytes a thread; with the query tile streamed (d > 288) the "
        f"dot and l2 kernels {attrs['stream_registers']} and "
        f"{attrs['stream_l2_registers']} registers, "
        f"{attrs['stream_spill_bytes']} and "
        f"{attrs['stream_l2_spill_bytes']} spill bytes")
    if any(attrs[f"{v}spill_bytes"] != 0
           for v in ("l2_", "stream_", "stream_l2_")):
        raise AssertionError(f"distance_topk spills registers: {attrs}")
    tile = tile_report("distance_topk", dist_ms, 2 * Q * n * D, dist_alone,
                       f"torch.mm [{Q}, {D}] x [{D}, {n}]", attrs)
    del s, vecs, live, liveq, new, pre, post, own
    torch.cuda.empty_cache()
    return {"launches": launches, "search_err": serr, "dist_err": derr,
            "times": (dist_ms, dist_plain, dist_lib), "bound": dist_bound,
            "tile": tile, "freq": freq, "midx": midx}


# ------------------------------------------------------------ the server --
def percentiles(lat) -> str:
    ms = sorted(x * 1e3 for x in lat)
    return (f"p50 {ms[len(ms) // 2]:.3f} ms, p99 "
            f"{ms[min(len(ms) - 1, int(len(ms) * 0.99))]:.3f} ms")


def open_loop(server, reqs, arrivals=None):
    """Submit (query row, params) requests from this one client thread,
    all at once or at ``arrivals`` (seconds after the first) -> (results,
    latencies submit -> result in s, wall s from the first submit to the
    last result). Each latency ends where the batcher resolves the
    future, not where this thread reads it."""
    n = len(reqs)
    sub, done, futs = [0.0] * n, [0.0] * n, []
    t0 = time.perf_counter()
    for i, (q, p) in enumerate(reqs):
        if arrivals is not None:
            wait = t0 + arrivals[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        sub[i] = time.perf_counter()
        f = server.submit(q, p)
        f.add_done_callback(
            lambda _, i=i: done.__setitem__(i, time.perf_counter()))
        futs.append(f)
    res = [f.result(timeout=600) for f in futs]
    return res, [d - s for s, d in zip(sub, done)], max(done) - sub[0]


def record_batches(server, snapshot=None):
    """Record each batch the server runs: its real rows n, params, the
    padded queries it searched, the result and (``snapshot``: a callable)
    the snapshot it read; and the launches the batch made, counted in the
    batcher thread itself."""
    from repro_torch.kernels import LAUNCHES
    rec = []
    run, search = server._run_batch, server._searcher

    def run_batch(batch, params):
        before = dict(LAUNCHES)
        rec.append({"n": len(batch), "params": params})
        out = run(batch, params)
        rec[-1]["launches"] = {k: c - before[k] for k, c in LAUNCHES.items()
                               if c != before[k]}
        return out

    def searcher(q, p):
        r = rec[-1]
        if snapshot is not None:
            r["snap"] = snapshot()
        res = search(q, p)
        r.update(q=q, res=res)
        return res

    server._run_batch, server._searcher = run_batch, searcher
    return rec


def served_gate(torch, name, rec, results, direct):
    """Every served row equals, bit for bit, its row of the recorded batch
    (arrival order: one client, groups close in order), and every recorded
    batch equals a direct search of the same padded batch at the same
    params (``direct(r)``) -> the served rows as device tensors."""
    import numpy as np
    cat = lambda f: torch.cat([getattr(r["res"], f)[:r["n"]]  # noqa: E731
                               for r in rec])
    ids, scores, nc = cat("ids"), cat("scores"), cat("n_candidates")
    if len(ids) != len(results):
        raise AssertionError(f"{name}: {len(results)} results, "
                             f"{len(ids)} recorded rows")
    if not (np.array_equal(np.stack([r.ids for r in results]),
                           ids.cpu().numpy())
            and np.array_equal(np.stack([r.scores for r in results]),
                               scores.cpu().numpy())
            and np.array_equal([r.n_candidates for r in results],
                               nc.cpu().numpy())):
        raise AssertionError(f"{name}: a served row differs from its "
                             f"batch's result")
    for r in rec:
        d = direct(r)
        if not (torch.equal(d.ids, r["res"].ids)
                and torch.equal(d.scores, r["res"].scores)
                and torch.equal(d.n_candidates, r["res"].n_candidates)
                and d.epoch == r["res"].epoch):
            raise AssertionError(f"{name}: a batch of {r['n']} differs "
                                 f"from a direct search of it")
    log(f"{name}: {len(results)} served rows equal their batches' rows, "
        f"and all {len(rec)} batches equal a direct search of the same "
        f"padded batch, bit for bit")
    return ids, scores, nc


def server_cell(torch, dev, idx, store8, corpus, midx, plain_search, agree):
    """The server cell: IRLIServer (max_batch 512, max_wait 2 ms, the probe
    counter on) over the search cell's frozen index with the int8 store,
    default SearchParams(m=5, tau=2, k=10, topC=1024, int8, auto), one
    request in eight at m=10 (launch/serve.py's wide override). A burst of
    N_BURST requests from one client thread, its first N_BARE without the
    probe counter, paced requests (seeded Poisson arrivals at half the
    burst's rate), then a server over the stream cell's MutableIRLIIndex
    with inserts and a delete as barriers. Gates: served rows bit-equal to
    direct searches of their padded batches and held to the plain search,
    the probe counter's sum, the launches by batch, the epochs."""
    import dataclasses

    import numpy as np

    from repro_torch.core.search_api import PipelineCache, SearchParams
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve.server import IRLIServer

    sp = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8")
    wide = sp.replace(m=WIDE_M)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def make_queries(n):
        src = torch.randint(0, corpus.shape[0], (n,), generator=gen,
                            device=dev)
        q = corpus[src] + 0.05 * torch.randn((n, D), generator=gen,
                                             device=dev)
        return (q / q.norm(dim=1, keepdim=True)).cpu().numpy()

    def mix(qs):
        return [(q, wide if i % 8 == 0 else sp) for i, q in enumerate(qs)]

    burst_q = make_queries(N_BURST)

    # ---- the burst, counters from 0 ----
    torch.cuda.synchronize()
    server = IRLIServer(idx, params=sp, base=store8)
    rec = record_batches(server)
    reset_launches()
    res, lat, wall = open_loop(server, mix(burst_q))
    server.close()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    st = server.stats
    qps = N_BURST / wall
    log(f"server burst: {N_BURST} requests (1 in 8 at m={WIDE_M}) in "
        f"{wall:.3f} s -> {qps:.1f} queries/s; latency {percentiles(lat)}; "
        f"{st['batches']} batches, pad_waste {st['pad_waste']}, param "
        f"groups {st['param_groups']}, cache {st['cache']}")
    probes = server.registry.vector("serve_bucket_probes", R * B).value
    want = R * sum(p.m for _, p in mix(burst_q))
    if float(probes.sum()) != float(want):
        raise AssertionError(f"serve_bucket_probes sums to {probes.sum()}, "
                             f"expected {want}")
    # each batch: one irli_topk for the probe, then the fused kernel or
    # the compact three; the batches' own counts sum to the run's
    mega = {"irli_topk": 1, "mega_query": 1}
    compact = {"irli_topk": 2, "freq_topc": 1, "quant_rerank": 1}
    kinds = [r["launches"] for r in rec]
    if any(k not in (mega, compact) for k in kinds):
        raise AssertionError(f"server batches launched {kinds[:5]}...")
    total = {}
    for k in kinds:
        for n, c in k.items():
            total[n] = total.get(n, 0) + c
    if total != launches or st["batches"] != len(rec):
        raise AssertionError(f"server launches {launches}, by batch "
                             f"{total}, {st['batches']} batches")
    log(f"server burst launches {launches}: {kinds.count(mega)} fused and "
        f"{kinds.count(compact)} compact batches, each with one irli_topk "
        f"for the probe counter; serve_bucket_probes sums to "
        f"{int(probes.sum())} = requests x R x m")
    def hold(name, rec):
        """Hold every served row of ``rec`` to the plain search: the rows
        of one params and one snapshot (the frozen index where a batch
        recorded none) in chunks of Q -> the largest score error."""
        err, groups = 0.0, {}
        for r in rec:
            groups.setdefault((r["params"], id(r.get("snap"))),
                              []).append(r)
        for (p, _), rows in groups.items():
            snap = rows[0].get("snap")
            base, state = store8, None
            if snap is not None:
                base = dataclasses.replace(snap.store, exact=snap.vecs)
                state = (snap.params, snap.members, snap.delta.members,
                         snap.tombstone)
            q = torch.cat([r["q"][:r["n"]] for r in rows])
            got = [torch.cat([getattr(r["res"], f)[:r["n"]] for r in rows])
                   for f in ("ids", "scores", "n_candidates")]
            at = f" at epoch {snap.epoch}" if snap is not None else ""
            for s in range(0, len(q), Q):
                plain, exempt, mcut = plain_search(p, base, q[s:s + Q],
                                                   state)
                err = max(err, agree(
                    f"{name} rows at m={p.m}{at} [{s}, "
                    f"{min(s + Q, len(q))})",
                    [g[s:s + Q] for g in got], plain, exempt, mcut))
        return err

    t_gate = time.perf_counter()
    served_gate(torch, "server burst", rec, res,
                lambda r: idx.search(r["q"], store8, r["params"]))
    err = hold("server burst", rec)
    log(f"server burst: gates took {time.perf_counter() - t_gate:.1f} s")

    # ---- the burst's first N_BARE requests without the probe counter ----
    server = IRLIServer(idx, params=sp, base=store8, probe_stats=False)
    _, lat0, wall0 = open_loop(server, mix(burst_q[:N_BARE]))
    server.close()
    qps0 = N_BARE / wall0
    log(f"server burst without the probe counter: its first {N_BARE} "
        f"requests at {qps0:.1f} queries/s (with it {qps:.1f}: the "
        f"probe's irli_topk a batch costs {1 - qps / qps0:.1%} of the wall "
        f"time); latency {percentiles(lat0)}")

    # ---- paced: Poisson arrivals at half the burst's rate ----
    rng = np.random.default_rng(SEED)
    arrivals = np.cumsum(rng.exponential(2.0 / qps, N_PACED))
    server = IRLIServer(idx, params=sp, base=store8)
    rec_p = record_batches(server)
    res_p, lat_p, wall_p = open_loop(server, mix(make_queries(N_PACED)),
                                     arrivals)
    server.close()
    log(f"server paced: {N_PACED} requests, Poisson arrivals at "
        f"{qps / 2:.1f}/s, served in {wall_p:.3f} s; latency "
        f"{percentiles(lat_p)}; {server.stats['batches']} batches")
    served_gate(torch, "server paced", rec_p, res_p,
                lambda r: idx.search(r["q"], store8, r["params"]))
    err = max(err, hold("server paced", rec_p))
    del rec_p, res_p

    # ---- mutations as barriers, over the stream cell's index ----
    n0 = midx.n_total
    live = torch.nonzero(~midx.snapshot.tombstone[:n0]).flatten()
    dead = live[torch.randperm(len(live), generator=gen,
                               device=dev)[:N_MUT_DEL]].cpu().numpy()
    mq = make_queries(N_MUT_Q)
    new = torch.randn((4 * MUT_INSERT, D), generator=gen, device=dev)
    new = (new / new.norm(dim=1, keepdim=True)).cpu().numpy()
    e_start = midx.epoch
    server = IRLIServer(midx, params=sp)
    rec_m = record_batches(server, snapshot=lambda: midx.snapshot)
    epochs = []
    apply = server._apply_mutation

    def apply_mutation(op, payload, fut):
        apply(op, payload, fut)
        epochs.append(midx.epoch)

    server._apply_mutation = apply_mutation
    futs, kinds, t0 = [], [], time.perf_counter()
    for i in range(N_MUT_Q):
        futs.append(server.submit(mq[i], sp))
        kinds.append("query")
        if (i + 1) % MUT_EVERY == 0:
            j = (i + 1) // MUT_EVERY - 1
            futs.append(server.insert(new[j * MUT_INSERT:
                                          (j + 1) * MUT_INSERT]))
            kinds.append("insert")
            if j == 1:
                futs.append(server.delete(dead))
                kinds.append("delete")
    out = [f.result(timeout=600) for f in futs]
    wall_m = time.perf_counter() - t0
    server.close()
    mut_i, expect, got = 0, [], []
    cur = e_start
    for kind, o in zip(kinds, out):
        if kind == "query":
            expect.append(cur)
            got.append(o.epoch)
        else:
            cur = epochs[mut_i]
            mut_i += 1
    if got != expect or any(b < a for a, b in zip(got, got[1:])):
        bad = sum(a != b for a, b in zip(got, expect))
        raise AssertionError(f"server mutations: {bad} queries served at "
                             f"another epoch than the last mutation before "
                             f"them left")
    after = [o for k, o in zip(kinds, out) if k == "query"][2 * MUT_EVERY:]
    if np.isin(np.stack([o.ids for o in after]), dead).any():
        raise AssertionError("a deleted id came back after its delete")
    log(f"server mutations: {N_MUT_Q} queries, {kinds.count('insert')} "
        f"inserts of {MUT_INSERT} and a delete of {len(dead)} live ids as "
        f"barriers, in {wall_m:.3f} s ({len(rec_m)} batches); every "
        f"query's epoch is the index's epoch after the last mutation before "
        f"it ({sorted(set(got))}), never going back; no deleted id returns")
    cache = PipelineCache()

    def at_snapshot(r):
        s = r["snap"]
        base = dataclasses.replace(s.store, exact=s.vecs)
        return cache.search(r["params"], s.params, s.members, base, r["q"],
                            s.delta.members, s.tombstone, epoch=s.epoch)

    served_gate(torch, "server mutations", rec_m,
                [o for k, o in zip(kinds, out) if k == "query"],
                at_snapshot)
    err = max(err, hold("server mutations", rec_m))
    del rec_m, out, rec
    torch.cuda.empty_cache()
    return {"launches": launches, "err": err, "qps": qps}


# ------------------------------------------------------------- the refit --
def refit_cell(torch, dev) -> dict:
    """The refit cell: a hash-partitioned index at the deep1b widths (R cut
    to REFIT_R) over FIT_L labels (sigmoid_bce, batch FIT_BATCH, affinity chunk FIT_CHUNK),
    wrapped in a MutableIRLIIndex (int8, capacity 2L, delta_len 208),
    served through IRLIServer with a QueryLog, a ShadowAuditor over the
    exact oracle and a DriftDetector; inserts and deletes through the
    server; one OnlineRefitLoop cycle (rows inserted while it runs are the
    swap's tail); then the artifact's checks and searches over it."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.artifact import IndexArtifact
    from repro_torch.checkpoint.checkpointer import CheckpointManager
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.search_api import SearchParams
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.online import refit as RF
    from repro_torch.serve.server import IRLIServer
    from repro_torch.stream import MutableIRLIIndex

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def unit(n):
        v = torch.randn((n, D), generator=gen, device=dev)
        return v / v.norm(dim=1, keepdim=True)

    corpus = unit(FIT_L)
    cfg = IRLIConfig(d=D, n_labels=FIT_L, n_buckets=B, n_reps=REFIT_R,
                     d_hidden=H, K=FIT_K, loss="sigmoid_bce",
                     batch_size=FIT_BATCH,
                     affinity_chunk=FIT_CHUNK, epochs_per_round=1, lr=1e-3,
                     seed=SEED)
    idx = IRLIIndex(cfg, device=dev)
    idx.build_index()                                 # the hash partition
    midx = MutableIRLIIndex(idx, corpus, capacity=2 * FIT_L,
                            delta_len=DELTA_LEN, store_dtype="int8")
    idx.opt_state = None                 # the refit round makes its own
    torch.cuda.synchronize()
    s0 = midx.snapshot
    ml0 = int(s0.members.shape[-1])
    log(f"refit setup: {time.perf_counter() - t0:.2f} s; L {FIT_L}, "
        f"capacity {midx.capacity}, members {tuple(s0.members.shape)}, "
        f"delta {tuple(s0.delta.members.shape)}, max load "
        f"{int(s0.load.max())}")
    del s0
    sp = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8")
    reg = obs.MetricRegistry()
    qlog = obs.QueryLog(capacity=8192, sample=1.0, registry=reg)
    auditor = obs.ShadowAuditor(
        midx.exact_oracle(K), sample=0.05, registry=reg,
        searcher=lambda q: midx.search(q, sp).ids)
    drift = obs.DriftDetector(obs.QuerySketch(D, 6, 0), registry=reg)
    server = IRLIServer(midx, params=sp, registry=reg, qlog=qlog,
                        auditor=auditor, drift=drift)
    try:
        src = torch.randint(0, FIT_L, (N_REFIT_Q,), generator=gen,
                            device=dev)
        qs = corpus[src] + 0.05 * torch.randn((N_REFIT_Q, D), generator=gen,
                                              device=dev)
        qs = (qs / qs.norm(dim=1, keepdim=True)).cpu().numpy()
        t0 = time.perf_counter()
        res, lat, wall = open_loop(server, [(q, sp) for q in qs])
        log(f"refit serve: {N_REFIT_Q} queries in {wall:.3f} s "
            f"({N_REFIT_Q / wall:.1f} queries/s), latency "
            f"{percentiles(lat)}; query log {len(qlog)} rows, auditor "
            f"sampled {int(reg.counter('quality_sampled_total').value)}")
        pre_new = unit(REFIT_INSERT)
        ins = server.insert(pre_new.cpu().numpy()).result(timeout=600)
        dead = torch.randperm(FIT_L, generator=gen,
                              device=dev)[:REFIT_DELETE]
        n_dead = server.delete(dead.cpu().numpy()).result(timeout=600)
        if n_dead != REFIT_DELETE or len(ins) != REFIT_INSERT:
            raise AssertionError(f"refit cell: {len(ins)} inserted, "
                                 f"{n_dead} deleted")
        tail = unit(REFIT_INSERT)
        tail_ids = []

        class TailLoop(RF.OnlineRefitLoop):
            """Rows that arrive while the cycle fits: inserted through the
            server after the round, before the artifact is sealed, so the
            swap re-places them under the new scorer."""

            def _build_artifact(self, state, s, n, sketch_hist=None):
                tail_ids.append(server.insert(
                    tail.cpu().numpy()).result(timeout=600))
                return super()._build_artifact(state, s, n, sketch_hist)

        replicas_s = []
        build_replicas = RF.build_replicas

        def timed_replicas(*a, **kw):
            t = time.perf_counter()
            out = build_replicas(*a, **kw)
            torch.cuda.synchronize()
            replicas_s.append(time.perf_counter() - t)
            return out

        RF.build_replicas = timed_replicas
        loop = TailLoop(midx, qlog, config=RF.RefitConfig(
            rounds_per_cycle=1, epochs_per_round=1, min_queries=REFIT_MIN_Q,
            hot_frac=REFIT_HOT), registry=reg, auditor=auditor, drift=drift)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            art = loop.run_cycle()
        finally:
            RF.build_replicas = build_replicas
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        launches = {n: c for n, c in LAUNCHES.items() if c}
        if art is None:
            raise AssertionError(f"the refit cycle did not fire: the log "
                                 f"holds {len(qlog)} rows")
        live = art.load
        log(f"refit cycle: {cycle_s:.3f} s (refit_cycle_seconds "
            f"{reg.histogram('refit_cycle_seconds').snapshot()['sum']:.3f}),"
            f" fit {reg.histogram('refit_fit_seconds').snapshot()['sum']:.3f}"
            f" s, swap pause "
            f"{midx.registry.histogram('stream_swap_seconds').snapshot()['sum']:.4f}"
            f" s, build_replicas {sum(replicas_s):.3f} s; loss "
            f"{reg.gauge('refit_loss').value:.5f}, re-assigned "
            f"{int(reg.gauge('refit_n_reassigned').value)}; artifact "
            f"v{art.version}: ML {art.members.shape[-1]} (the hash "
            f"partition's {ml0}), "
            f"live max load {int(live.max())} (mean "
            f"{float(live.float().mean()):.2f}), replicas "
            f"{None if art.replicas is None else tuple(art.replicas.shape)}"
            f", {len(tail_ids[0])} tail rows re-placed; audited recall pre "
            f"{reg.gauge('refit_audited_recall_pre').value:.4f} post "
            f"{reg.gauge('refit_audited_recall_post').value:.4f}")
        need = ("bce_logits", "irli_topk", "kchoice", "distance_topk")
        if any(launches.get(n, 0) < 1 for n in need) \
                or launches["kchoice"] < 3:
            raise AssertionError(f"the refit cycle launched {launches}")
        log(f"refit cycle launches {launches} (the round, the tail's "
            f"insert and its re-placement, the audits and telemetry)")

        # ---- the artifact ----
        t = [time.perf_counter()]
        art.verify()
        t.append(time.perf_counter())
        ckpt = Path(__file__).resolve().parent / "build" / "refit_artifact"
        mgr = CheckpointManager(str(ckpt), keep=1)
        art.save(mgr)
        mgr.wait()
        t.append(time.perf_counter())
        back = IndexArtifact.restore(mgr, device=dev)
        t.append(time.perf_counter())
        if back.checksum != art.checksum:       # restore() verified it
            raise AssertionError("the restored artifact's digest differs")
        log(f"refit artifact: verify() passes; saved, restored, digest "
            f"{art.checksum[:16]}... equal; verify {t[1] - t[0]:.2f} s, "
            f"save {t[2] - t[1]:.2f} s, restore {t[3] - t[2]:.2f} s")
        del back

        # ---- serving over it ----
        res = [server.submit(q, sp) for q in qs[:1024]]
        res = [f.result(timeout=600) for f in res]
        if {r.epoch for r in res} != {midx.epoch} or midx.epoch < \
                art.version:
            raise AssertionError(f"epochs after the swap "
                                 f"{sorted({r.epoch for r in res})}, index "
                                 f"{midx.epoch}, artifact v{art.version}")
        if np.isin(np.stack([r.ids for r in res]), dead.cpu().numpy()).any():
            raise AssertionError("a deleted id came back after the swap")
        own = midx.search(tail, sp)
        rate = float((own.ids[:, 0] == tail_ids[0].to(dev)).float().mean())
        own = midx.search(pre_new, sp)
        rate_pre = float((own.ids[:, 0] == ins.to(dev)).float().mean())
        log(f"refit swap: {len(res)} later results at epoch {midx.epoch} "
            f"(artifact v{art.version}); {rate:.4f} of the {REFIT_INSERT} "
            f"tail inserts and {rate_pre:.4f} of the {REFIT_INSERT} rows "
            f"inserted before the cycle return their own id at rank 0; no "
            f"deleted id returns")
        if rate < 0.99:
            raise AssertionError(f"only {rate} of the tail inserts find "
                                 f"themselves")
        q = torch.from_numpy(qs[:Q]).to(dev)
        for mode in ("compact", "auto"):
            p = sp.replace(mode=mode)
            a = midx.search(q, p)
            b = midx.search(q, p, staged=True)
            if not (torch.equal(a.ids, b.ids)
                    and torch.equal(a.scores, b.scores)
                    and torch.equal(a.n_candidates, b.n_candidates)):
                raise AssertionError(f"staged {mode} differs from unstaged")
        snap = obs.DEFAULT_REGISTRY.snapshot()
        labels = {k.split('"')[1] for k in snap
                  if k.startswith("serve_stage_seconds")}
        want = {"scorer_logits", "top_m", "gather", "freq_topc", "mega"}
        if not want <= labels:
            raise AssertionError(f"staged labels {sorted(labels)}")
        hot = midx.search(q, sp.replace(hot_replicas=True))
        if hot.ids.shape != (Q, K) or int((hot.ids[:, 0] >= 0).sum()) == 0:
            raise AssertionError("the hot-replica search returned nothing")
        audit = auditor.run_audit()
        drift_kl = drift.score()
        log(f"refit: staged = unstaged bit for bit (compact and auto), "
            f"labels {sorted(labels)}; hot_replicas search ran "
            f"({int((hot.ids[:, 0] >= 0).sum())}/{Q} rows with a result); "
            f"shadow audit live recall "
            f"{'none sampled' if audit is None else round(audit['live_recall'], 4)}"
            f", drift KL {drift_kl:.4f}")
    finally:
        server.close()
    del midx, idx, server, art, corpus
    torch.cuda.empty_cache()
    return {"launches": launches}


# ------------------------------------------------------- the distributed --
def shard_members(torch, dev, s: int):
    """Shard s's own hash partition over its DIST_L rows (seed SEED + 1 +
    s, max_load 2·⌈DIST_L/B⌉) -> members [R, B, ML]."""
    from repro_torch.core import partition as PT
    a = PT.hash_init(DIST_L, B, R, seed=SEED + 1 + s, device=dev)
    return PT.build_inverted_index(a, B, max_load=2 * -(-DIST_L // B)
                                   ).members


def serve_scorer(torch, dev) -> dict:
    """The search cell's scorer: IRLIIndex's own draw at seed SEED."""
    from repro_torch.core.network import ScorerConfig, scorer_init
    return scorer_init(ScorerConfig(d_in=D, d_hidden=H, n_buckets=B,
                                    n_reps=R),
                       torch.Generator(device=dev).manual_seed(SEED))


def narrow_config(**over):
    """The 2 x 2 mesh fit's config: the fit cell's at narrow widths (B =
    2000, R = 4, H = 256) over NARROW_L labels, 2 rounds, batch 1024 and
    an affinity chunk of 2048 (4 chunks: the data axis splits them)."""
    return fit_config(NARROW_L, rounds=2, batch_size=1024,
                      affinity_chunk=2048, **{**NARROW, **over})


def dist_rank(rank: int, world: int, tmp: str, dev_type: str) -> None:
    """One of the DIST_P gloo ranks on the card (spawned by dist_cell):
    (b) its shard of the search cell's corpus through build_irli_serve and
    make_production_search over a ("data", "model") = (DIST_P, 1) mesh;
    (c) the narrow fit on a 2 x 2 ("data", "rep") mesh. Writes its results
    to tmp/rank<rank>.pt, or its traceback to tmp/err<rank>.txt."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    try:
        dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=300))
        out = {"search": dist_rank_search(torch, dev, world),
               "fit": dist_rank_fit(torch, dev, world, tmp),
               "trainer": train_rank_work(torch, dev, world, tmp)}
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def dist_rank_search(torch, dev, world: int) -> dict:
    from repro_torch.core.distributed import (axis_group,
                                              make_production_search)
    from repro_torch.core.search_api import SearchParams
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_irli_serve
    from repro_torch.store.quantized import encode

    mesh = make_host_mesh(world, device_type=dev.type)
    shard = axis_group(mesh, mesh.mesh_dim_names).index
    corpus, queries = serve_data(torch, dev)
    store = encode(corpus[shard * DIST_L:(shard + 1) * DIST_L].contiguous(),
                   "int8", BLOCK)
    del corpus
    params = {"scorer": serve_scorer(torch, dev),
              "members": shard_members(torch, dev, shard),
              "base_codes": store.codes, "base_scales": store.scales}
    sp = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8")
    search = make_production_search(mesh, sp)
    step = build_irli_serve(mesh, M, TAU, K, store_dtype="int8",
                            store_block=BLOCK)
    batch = {"queries": queries}
    torch.cuda.synchronize()
    reset_launches()
    out = step(params, batch)
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    res = search(params["scorer"], params["members"], store, queries)
    ms = time_ms(torch, lambda: step(params, batch), n=5, warmup=1)
    return {"shard": shard, "peak_gb": torch.cuda.max_memory_allocated()
            / 1e9 if dev.type == "cuda" else 0.0, "ids": out["ids"].cpu(),
            "scores": out["scores"].cpu(), "res_ids": res.ids.cpu(),
            "res_scores": res.scores.cpu(),
            "n_candidates": res.n_candidates.cpu(), "launches": launches,
            "ms": ms}


def dist_rank_fit(torch, dev, world: int, tmp: str) -> dict:
    from repro_torch.core.index import IRLIIndex
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_fit_mesh

    mesh = make_fit_mesh(world, rep_axis=2, device_type=dev.type)
    data = torch.load(Path(tmp) / "narrow.pt")
    base, labels = data["base"].to(dev), data["labels"].to(dev)
    idx = IRLIIndex(narrow_config(), device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = idx.fit(base, labels, label_vecs=base, mesh=mesh)
    torch.cuda.synchronize()
    return {"loss": st.train_loss, "epoch_loss": st.epoch_loss,
            "load_std": st.load_std, "n_reassigned": st.n_reassigned,
            "assign": idx.assign.cpu(), "launches": {
                n: c for n, c in LAUNCHES.items() if c},
            "seconds": time.perf_counter() - t0}


def spawn_ranks(fn, world: int, tmp: str, dev_type: str,
                timeout: float) -> None:
    """Run fn(rank, world, tmp, dev_type) in ``world`` processes started with the
    spawn method (the card is initialised here already); raise with their
    tracebacks if any fails or outlives ``timeout`` s. Every process is
    stopped before this returns."""
    join_ranks(start_ranks(fn, world, tmp, dev_type), tmp, timeout)


def start_ranks(fn, world: int, tmp: str, dev_type: str) -> list:
    """Start fn(rank, world, tmp, dev_type) in ``world`` processes with the
    spawn method; ``join_ranks`` waits for them."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, tmp, dev_type))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_ranks(procs: list, tmp: str, timeout: float) -> None:
    """Wait up to ``timeout`` s for ranks from ``start_ranks``; raise with
    their tracebacks if any failed or is still running (it is killed)."""
    end = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    text = "\n".join(f.read_text() for f in sorted(Path(tmp).glob("err*")))
    if text or hung or any(p.exitcode for p in procs):
        raise AssertionError(f"distributed ranks {hung} outlived {timeout} "
                             f"s; exit codes {[p.exitcode for p in procs]}"
                             f"\n{text}")


def dist_cell(torch, dev, idx, store8, queries) -> dict:
    """The distributed cell (core/distributed.py, launch/steps.
    build_irli_serve, the mesh fit):
    (a) an NCCL process group of world size 1 in this process:
        build_irli_serve / make_production_search over the search cell's
        index, int8 store and queries, bit-equal to the compact search
        (ids, n_candidates, scores), both timed (the difference is the
        merge's cost); then the fit cell's config over DIST_FIT_L labels,
        one round, through IRLIIndex.fit with a 1 x 1 ("data", "rep")
        mesh, bit-equal to the same fit without one (assign, losses,
        params);
    (b) DIST_P gloo ranks spawned on the one card (NCCL refuses two ranks
        on one device; the same ranks then run the train cell's (b),
        ``train_rank_work``, whose results this cell returns as
        "trainer_ranks"), each holding DIST_L rows of the same corpus with
        its own hash partition, the replicated scorer and the same
        queries: all ranks return the same result, equal to this
        process's loop over the shards through shard_search_local merged
        by a stable sort on the host (ids and n_candidates exactly, scores
        bit-equal); the ranks time-share the card, so their times are
        correctness only;
    (c) in the same ranks, the narrow fit on a 2 x 2 mesh, held to the
        single-device fit in this process with tests/test_fit_engine.py's
        tolerances (loss rtol 1e-4, assign match > 0.98, load_std rtol
        0.05)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.distributed import shard_search_local
    from repro_torch.core.index import IRLIIndex
    from repro_torch.core.search_api import SearchParams
    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_fit_mesh, make_host_mesh
    from repro_torch.launch.steps import build_irli_serve
    from repro_torch.core.distributed import make_production_search
    from repro_torch.store.quantized import QuantizedStore

    t_cell = time.perf_counter()
    compact = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8",
                           mode="compact")
    launches = {}
    tmp = tempfile.mkdtemp(prefix="irli_dist_")
    # ------------------------------------- (a) world size 1, over NCCL --
    t0 = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(
        str(Path(tmp) / "solo_store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, device_type=dev.type)
        log(f"distributed (a): {backend} group of world size 1 and a "
            f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} mesh in "
            f"{time.perf_counter() - t0:.2f} s")
        params = {"scorer": idx.params, "members": idx.index.members,
                  "base_codes": store8.codes, "base_scales": store8.scales}
        step = build_irli_serve(mesh, M, TAU, K, store_dtype="int8",
                                store_block=BLOCK)
        search = make_production_search(mesh, compact)
        batch = {"queries": queries}
        want = idx.search(queries, store8, compact)
        search(idx.params, idx.index.members, store8, queries)
        torch.cuda.synchronize()
        reset_launches()
        out = step(params, batch)
        torch.cuda.synchronize()
        launches["serve"] = {n: c for n, c in LAUNCHES.items() if c}
        if launches["serve"] != {"irli_topk": 1, "freq_topc": 1,
                                 "quant_rerank": 1}:
            raise AssertionError(f"build_irli_serve launched "
                                 f"{launches['serve']}")
        res = search(idx.params, idx.index.members, store8, queries)
        for name, got in (("build_irli_serve", (out["ids"], out["scores"],
                                                want.n_candidates)),
                          ("make_production_search",
                           (res.ids, res.scores, res.n_candidates))):
            if not (torch.equal(got[0], want.ids)
                    and torch.equal(got[1], want.scores)
                    and torch.equal(got[2], want.n_candidates)):
                raise AssertionError(f"{name} at world size 1 is not "
                                     f"bit-equal to the compact search")
        log(f"distributed (a) make_production_search and build_irli_serve "
            f"at L={L}, Q={Q} "
            f"(int8, m={M}, tau={TAU}, k={K}, topC={TOPC}): ids, "
            f"n_candidates and scores bit-equal to the compact search; "
            f"launches {launches['serve']}")
        serve_ms = compact_ms = 0.0
        for _ in range(2):                       # interleaved, twice
            compact_ms += time_ms(torch, lambda: idx.search(
                queries, store8, compact), n=10) / 2
            serve_ms += time_ms(torch, lambda: step(params, batch),
                                n=10) / 2
        from repro_torch.core.distributed import (_merge_across_shards,
                                                  axis_group)
        grp = axis_group(mesh, mesh.mesh_dim_names)
        merge_ms = time_ms(torch, lambda: _merge_across_shards(
            want.ids, want.scores, want.n_candidates, K, grp), n=20)
        log(f"distributed (a) times: build_irli_serve {serve_ms:.4f} ms, "
            f"the compact search {compact_ms:.4f} ms (difference "
            f"{serve_ms - compact_ms:.4f} ms); the merge alone (one NCCL "
            f"all-gather of [{Q}, {2 * K}] int32 + one all-reduce of "
            f"[{Q}] int32 + the stable top-{K}) {merge_ms:.4f} ms")

        # the 1 x 1 mesh fit at deep1b widths, bit-equal
        fbase = clustered_vectors(n_base=DIST_FIT_L, n_queries=1, d=D,
                                  seed=SEED)[0]
        fbase = torch.from_numpy(fbase).to(dev)
        flabels = neighbours(torch, dev, fbase, fbase, K_NEIGH)
        cfg = fit_config(DIST_FIT_L, rounds=1)
        fits, secs = [], []
        for fmesh in (None, make_fit_mesh(1, device_type=dev.type)):
            fidx = IRLIIndex(cfg, device=dev)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            st = fidx.fit(fbase, flabels, label_vecs=fbase, mesh=fmesh)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            fits.append((fidx, st, {n: c for n, c in LAUNCHES.items()
                                    if c}))
        (one, s1, l1), (two, s2, l2) = fits
        launches["fit 1x1"] = l2
        steps = -(-DIST_FIT_L // FIT_BATCH)
        fwant = {"bce_logits": steps, "irli_topk": -(-DIST_FIT_L // FIT_CHUNK),
                 "kchoice": 1}
        if l2 != fwant:
            raise AssertionError(f"the 1 x 1 mesh fit launched {l2}, "
                                 f"expected {fwant}")
        same = (torch.equal(one.assign, two.assign)
                and s1.train_loss == s2.train_loss
                and s1.epoch_loss == s2.epoch_loss
                and all(torch.equal(one.params[k], two.params[k])
                        for k in one.params)
                and all(torch.equal(one.opt_state[m][k],
                                    two.opt_state[m][k])
                        for m in ("m", "v") for k in one.params))
        if not same or l1 != l2:
            raise AssertionError(f"the 1 x 1 mesh fit is not bit-equal to "
                                 f"the single-device fit: losses "
                                 f"{s1.train_loss} / {s2.train_loss}, "
                                 f"launches {l1} / {l2}")
        log(f"distributed (c) 1 x 1 NCCL mesh fit at deep1b widths, "
            f"{DIST_FIT_L} labels, 1 round of {steps} steps: assign, losses ({s2.train_loss}), params and AdamW "
            f"moments bit-equal to the single-device fit; "
            f"{secs[1]:.3f} s against {secs[0]:.3f} s; launches {l2}")
        del fits, one, two, fbase, flabels
    finally:
        dist.destroy_process_group()

    # ----------------------------------------- (b) + (c) on gloo ranks --
    narrow_data(torch, dev, tmp)
    narrow = torch.load(Path(tmp) / "narrow.pt")
    nbase, nlabels = narrow["base"].to(dev), narrow["labels"].to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(dist_rank, DIST_P, tmp, dev.type, timeout=400)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(DIST_P)]

    # this process's loop over the shards, merged on the host
    ids, scores, ncand = [], [], 0
    for s in range(DIST_P):
        rows = slice(s * DIST_L, (s + 1) * DIST_L)
        st = QuantizedStore("int8", BLOCK, store8.codes[rows],
                            store8.scales[rows])
        r = shard_search_local(idx.params, shard_members(torch, dev, s), st,
                               queries, compact, q_chunk=Q)
        ids.append(torch.where(r.ids >= 0, r.ids + s * DIST_L, r.ids).cpu())
        scores.append(r.scores.cpu())
        ncand = ncand + r.n_candidates.cpu()
    ids, scores = torch.cat(ids, 1), torch.cat(scores, 1)
    order = torch.sort(scores, dim=1, descending=True, stable=True
                       ).indices[:, :K]
    want_ids, want_scores = ids.gather(1, order), scores.gather(1, order)
    for rk in ranks:
        got = rk["search"]
        for a, b in ((got["ids"], want_ids), (got["scores"], want_scores),
                     (got["res_ids"], want_ids),
                     (got["res_scores"], want_scores),
                     (got["n_candidates"], ncand)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"distributed (b): rank of shard {got['shard']} differs "
                    f"from the host merge of the shard loop")
    slaunch = {}
    for rk in ranks:
        for n, c in rk["search"]["launches"].items():
            slaunch[n] = slaunch.get(n, 0) + c
    launches["serve, 4 ranks"] = slaunch
    if slaunch != {"irli_topk": DIST_P, "freq_topc": DIST_P,
                   "quant_rerank": DIST_P}:
        raise AssertionError(f"the ranks' searches launched {slaunch}")
    log(f"distributed (b) {DIST_P} gloo ranks on the card (spawned, "
        f"{ranks_s:.1f} s in all with (c)), {DIST_L} rows each: every rank's "
        f"build_irli_serve and make_production_search result bit-equal to "
        f"the host merge of shard_search_local over the {DIST_P} shards "
        f"(ids, n_candidates, scores); survivors/query mean "
        f"{float(ncand.float().mean()):.1f}; peak device memory a rank "
        f"{[round(rk['search']['peak_gb'], 3) for rk in ranks]} GB "
        f"(torch's allocator, without the CUDA context); launches "
        f"{slaunch}; the ranks "
        f"time-share one card, so their step times "
        f"{[round(rk['search']['ms'], 4) for rk in ranks]} ms are "
        f"correctness only, not speed")

    # (c) the 2 x 2 fit against the single-device fit here
    ref = IRLIIndex(narrow_config(), device=dev)
    t0 = time.perf_counter()
    rst = ref.fit(nbase, nlabels, label_vecs=nbase)
    ref_s = time.perf_counter() - t0
    fl = {}
    for rk in ranks:
        got = rk["fit"]
        if got["loss"] != ranks[0]["fit"]["loss"] or not torch.equal(
                got["assign"], ranks[0]["fit"]["assign"]):
            raise AssertionError("distributed (c): the 2 x 2 fit's ranks "
                                 "disagree")
        for n, c in got["launches"].items():
            fl[n] = fl.get(n, 0) + c
    launches["fit 2x2, 4 ranks"] = fl
    got = ranks[0]["fit"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       rst.train_loss))
    ep_rel = max(abs(a - b) / abs(b) for ga, ra in zip(got["epoch_loss"],
                                                       rst.epoch_loss)
                 for a, b in zip(ga, ra))
    match = float((got["assign"] == ref.assign.cpu()).float().mean())
    std_rel = max(abs(a - b) / b for a, b in zip(got["load_std"],
                                                 rst.load_std))
    log(f"distributed (c) 2 x 2 gloo mesh fit (B={NARROW['n_buckets']}, "
        f"R={NARROW['n_reps']}, H={NARROW['d_hidden']}, {NARROW_L} labels, "
        f"2 rounds): losses {got['loss']} against {rst.train_loss} (largest "
        f"relative difference {loss_rel:.3g}, epochs {ep_rel:.3g}), assign "
        f"match {match:.4f}, load_std {got['load_std']} against "
        f"{rst.load_std} (rel {std_rel:.3g}); {got['seconds']:.2f} s on the "
        f"ranks (correctness only) against {ref_s:.2f} s alone; launches "
        f"{fl}")
    if not (loss_rel <= 1e-4 and ep_rel <= 1e-4 and match > 0.98
            and std_rel <= 0.05 and len(got["loss"]) == len(rst.train_loss)):
        raise AssertionError("distributed (c): the 2 x 2 mesh fit is off "
                             "the single-device fit's tolerances")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"distributed cell: {time.perf_counter() - t_cell:.1f} s")
    return {"launches": launches, "serve_ms": serve_ms,
            "compact_ms": compact_ms, "merge_ms": merge_ms,
            "trainer_ranks": [rk["trainer"] for rk in ranks]}


# ------------------------------------------------------------ the audit --
AUDIT_Q = 1000                   # full width: no other size of the call
AUDIT_FIT_CHUNK = 8192           # 4 label chunks of DIST_FIT_L


def audit_report(r) -> None:
    """Log one contract's verdict, peak intermediate and time; raise when
    it failed or its control did not trip."""
    from repro_torch.launch.audit import report_lines
    for line in report_lines(r):
        log(f"audit {line.strip()}")
    if not r.passed or r.skipped:
        raise AssertionError(f"contract {r.contract_id} failed on the card: "
                             f"{r.to_dict()}")


def one_kernel(r) -> tuple:
    """The CUDA kernels that max_dispatches saw in a passed
    query.mega_single_dispatch report, its call's and its control's (empty
    when the control did not run); raises unless the call's are exactly one
    mega_query kernel. A passed report holds a call the profiler did not
    miss a kernel of."""
    def seen(checks):
        return next((c.kernels for c in checks
                     if c.check.startswith("max_dispatches")), ())
    call = seen(r.checks)
    if not r.passed or len(call) != 1 or "mega_query" not in call[0]:
        raise AssertionError(f"audit: the fused search ran {list(call)} on "
                             f"the card, not exactly one mega_query kernel")
    return call, seen(r.control_checks)


def audit_cell(torch, dev, idx, store8, queries) -> dict:
    """The audit cell (repro_torch/analysis, launch/audit.py):
    (a) every registered contract at the reference's fixture sizes on the
        card (the mesh contracts in one world of 4 gloo ranks spawned on
        the card), each control tripped; the card-side sightings (an
        intermediate a kernel keeps on chip, counted only when that
        kernel launched in the call) listed; query.mega_single_dispatch
        exactly one CUDA kernel, mega_query, and its staged control more
        than one; the fit round's backward recorded by the op recorder;
    (b) the four seeded violations, each detected on the card;
    (c) at full width: the search cell's index and int8 store at Q =
        AUDIT_Q (the compact search: query.compact_no_dense_table and
        store.int8_no_fp32_payload; IRLIIndex.search at mode "auto", which
        resolves to "mega": query.mega_single_dispatch, one launch), and
        the distributed cell's cut of the fit (DIST_FIT_L labels, one
        round, affinity chunk AUDIT_FIT_CHUNK so that chunk and L differ):
        fit.round_no_dense_affinity and fit.round_donates_state. Controls
        run at the toy size only."""
    import dataclasses

    from repro_torch.analysis import REGISTRY, contracts as C, load_all
    from repro_torch.analysis import fixtures as FX
    from repro_torch.core.index import IRLIIndex
    from repro_torch.core.network import ScorerConfig
    from repro_torch.core.query import QueryPipeline
    from repro_torch.core.search_api import SearchParams
    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.fit.engine import FitData, FitEngine
    from repro_torch.fit.state import FitState
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import audit as AU
    from repro_torch.store.rerank import resolve_refine_k

    t_cell = time.perf_counter()
    torch.cuda.synchronize()
    reset_launches()
    ids = load_all()
    # ------------------------------------------- (a) the whole registry --
    t0 = time.perf_counter()
    reports = AU.audit_ids(ids, device=dev)
    held = {}
    for r in reports:
        audit_report(r)
        negative = any(c.kind in ("forbid_dims", "require_dtype_free",
                                  "max_intermediate_bytes", "max_dispatches",
                                  "require_donated")
                       for c in REGISTRY.get(r.contract_id).checks)
        if negative and r.control_ok is not True:
            raise AssertionError(f"{r.contract_id}: its control did not "
                                 f"trip: {r.control_detail}")
        for c in r.checks:
            if c.held_by:
                held.setdefault(r.contract_id, []).append(
                    f"{c.check} held on chip by {c.held_by}")
    registry_s = time.perf_counter() - t0
    log(f"audit (a): {len(reports)} contracts passed on the card in "
        f"{registry_s:.1f} s, every control tripped; card-side sightings: "
        f"{json.dumps(held)}")
    mega, split = one_kernel(next(r for r in reports if r.contract_id ==
                                  "query.mega_single_dispatch"))
    log(f"audit (a): query.mega_single_dispatch's call ran CUDA kernels "
        f"{list(mega)}; its staged control {len(split)} kernels")
    if len(split) <= 1:
        raise AssertionError("audit (a): the staged control of the fused "
                             "search is not more than one kernel")
    with C.on_device(dev):
        fit = FX.fit_round().trace()
    backward = sorted({r.op for r in fit.ops if "backward" in r.op})
    log(f"audit (a): the fit round's op record holds {len(fit.ops)} op "
        f"outputs, its backward ops included: {backward}")
    if not backward:
        raise AssertionError("audit (a): the op recorder saw no backward op "
                             "of the fit round on the card")
    del fit
    # -------------------------------------------- (b) seeded violations --
    t0 = time.perf_counter()
    for name in sorted(AU.SEEDED):
        r = AU.audit_seeded(name, device=dev)
        bad = [f"{c.check}: {c.detail}" for c in r.checks if not c.passed]
        log(f"audit (b): --seed-violation {name} detected on the card: "
            f"{bad or r.control_detail}")
        if r.passed:
            raise AssertionError(f"audit (b): seeded violation {name} went "
                                 f"undetected on the card")
    seeded_s = time.perf_counter() - t0
    # ------------------------------------------------- (c) full width --
    t0 = time.perf_counter()
    q = queries[:AUDIT_Q].contiguous()
    kp = resolve_refine_k(0, K, TOPC)
    pipe = QueryPipeline(m=M, tau=TAU, k=K, mode="compact", topC=TOPC,
                         store_dtype="int8")
    dims = {"Q": AUDIT_Q, "L": L, "C": TOPC, "D": D, "kp": kp, "k": K}
    compact = C.Fixture(fn=lambda p, mem, s, qq: pipe.search(p, mem, s, qq),
                        args=(idx.params, idx.index.members, store8, q),
                        dims=dims)
    auto = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8",
                        mode="auto")
    fused = C.Fixture(fn=lambda qq: idx.search(qq, store8, auto).ids,
                      args=(q,), dims=dims)
    fbase = torch.from_numpy(clustered_vectors(
        n_base=DIST_FIT_L, n_queries=1, d=D, seed=SEED)[0]).to(dev)
    flabels = neighbours(torch, dev, fbase, fbase, K_NEIGH)
    cfg = fit_config(DIST_FIT_L, rounds=1, affinity_chunk=AUDIT_FIT_CHUNK)
    fidx = IRLIIndex(cfg, device=dev)
    engine = FitEngine(cfg, ScorerConfig(d_in=D, d_hidden=H, n_buckets=B,
                                         n_reps=R, loss=cfg.loss))
    data = FitData.build(fbase, flabels, label_vecs=fbase,
                         n_labels=DIST_FIT_L, chunk=AUDIT_FIT_CHUNK,
                         device=dev)
    state = FitState(params=fidx.params, opt_state=fidx.opt_state,
                     assign=fidx.assign, rng=fidx.rng, round_idx=0,
                     epoch_idx=0)
    bidx, w = engine.round_batches(DIST_FIT_L, SEED, 0)
    fit_fx = C.Fixture(
        fn=lambda s, i, ww: engine.round_body(s, i, ww, data, None),
        args=(state, bidx, w), donate_argnums=(0,),
        dims={"L": DIST_FIT_L, "B": B, "chunk": AUDIT_FIT_CHUNK,
              "K": FIT_K})
    full = {}
    for cid, fx in (("query.compact_no_dense_table", compact),
                    ("store.int8_no_fp32_payload", compact),
                    ("query.mega_single_dispatch", fused),
                    ("fit.round_no_dense_affinity", fit_fx),
                    ("fit.round_donates_state", fit_fx)):
        contract = dataclasses.replace(REGISTRY.get(cid),
                                       fixture=lambda fx=fx: fx)
        r = contract.audit(run_control=False, device=dev)
        audit_report(r)
        if cid == "query.mega_single_dispatch":
            fused_kernels, _ = one_kernel(r)
        full[cid] = {"peak_bytes": r.peak_bytes, "peak": r.peak,
                     "seconds": r.seconds,
                     "held": [c.held_by for c in r.checks if c.held_by]}
    full_s = time.perf_counter() - t0
    log(f"audit (c) at full width (Q = {AUDIT_Q}, L = {L}; the fit at "
        f"{DIST_FIT_L} labels, chunk {AUDIT_FIT_CHUNK}): "
        f"{json.dumps(full)}; IRLIIndex.search (auto -> mega) ran "
        f"{list(fused_kernels)}")
    del compact, fused, fit_fx, state, fidx, data, fbase, flabels
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    log(f"audit cell: {time.perf_counter() - t_cell:.1f} s ((a) "
        f"{registry_s:.1f} s, (b) {seeded_s:.1f} s, (c) {full_s:.1f} s); "
        f"launches {launches}")
    return {"launches": launches, "held": held, "full": full,
            "seconds": time.perf_counter() - t_cell}


# ------------------------------------------------------------ the train --
# the train cell: (a) the Trainer over build_irli_fit_parts at the fit
# cell's config with R cut from 32 to TRAIN_R (R counts independent
# repetitions, the fit's depth), TRAIN_ROUNDS rounds of 1 epoch, a
# checkpoint every TRAIN_EVERY rounds, a crash before round TRAIN_FAIL; (b)
# the mesh Trainer at the narrow widths on DIST_P gloo ranks; (c) DIEN's
# retrieval_cand; (e) THREAD_CALLS calls of each TMA kernel from a new
# thread after THREAD_MAIN of its own and THREAD_IRLI irli_topk launches
TRAIN_R, TRAIN_ROUNDS, TRAIN_EVERY, TRAIN_FAIL = 2, 3, 2, 2
THREAD_MAIN, THREAD_IRLI, THREAD_CALLS = 300, 1000, 20
TMA_KERNELS = ("mega_query", "irli_topk", "distance_topk", "flash_attention")


def train_config(**over):
    """The train cell's config: the fit cell's (fit_config(FIT_L)) with R =
    TRAIN_R and TRAIN_ROUNDS rounds."""
    return fit_config(FIT_L, n_reps=TRAIN_R, rounds=TRAIN_ROUNDS, **over)


def trainer_for(torch, dev, cfg, base, labels, ckpt, fail_at=None,
                mesh=None):
    """A Trainer over build_irli_fit_parts(cfg, base, labels, label_vecs=
    base) writing to ckpt (TRAIN_ROUNDS rounds, a checkpoint every
    TRAIN_EVERY)."""
    from repro_torch.launch.steps import build_irli_fit_parts
    from repro_torch.train.trainer import Trainer, TrainerConfig
    parts = build_irli_fit_parts(cfg, base, labels, label_vecs=base,
                                 mesh=mesh, device=dev)
    return Trainer(TrainerConfig(total_steps=TRAIN_ROUNDS,
                                 checkpoint_every=TRAIN_EVERY,
                                 fail_at_step=fail_at), *parts, str(ckpt),
                   device=dev, sharded=parts.sharded)


def crash_and_resume(torch, make, resume_make=None) -> tuple:
    """make(fail_at) -> a Trainer. Runs one that fails before round
    TRAIN_FAIL, then resumes with (resume_make or make)(None) -> (the
    resumed Trainer, its run's output)."""
    from repro_torch.train.trainer import SimulatedFailure
    try:
        make(TRAIN_FAIL).run()
    except SimulatedFailure:
        pass
    else:
        raise AssertionError("fail_at_step raised no SimulatedFailure")
    tr = (resume_make or make)(None)
    if not (tr.resumed and tr.start_step == TRAIN_FAIL):
        raise AssertionError(f"the Trainer did not resume at round "
                             f"{TRAIN_FAIL}: {tr.resumed}, {tr.start_step}")
    return tr, tr.run()


def train_rank_work(torch, dev, world: int, tmp: str) -> dict:
    """The train cell's (b) on one of DIST_P gloo ranks (the distributed
    cell's ranks, or ``train_rank``'s): the mesh Trainer at the narrow
    config over tmp/narrow.pt, TRAIN_ROUNDS rounds uninterrupted on a 2 x
    2 ("data", "rep") mesh, then crashed before round TRAIN_FAIL on 2 x 2
    and resumed on 1 x 4 -> each run's losses and whole final state."""
    from repro_torch.launch.mesh import make_fit_mesh
    t0 = time.perf_counter()
    data = torch.load(Path(tmp) / "narrow.pt")
    base, labels = data["base"].to(dev), data["labels"].to(dev)
    cfg = narrow_config()
    m22 = make_fit_mesh(world, rep_axis=2, device_type=dev.type)
    full = trainer_for(torch, dev, cfg, base, labels,
                       Path(tmp) / "full", mesh=m22)
    fout = full.run()
    m14 = make_fit_mesh(world, rep_axis=world, device_type=dev.type)
    res, rout = crash_and_resume(
        torch, lambda f: trainer_for(torch, dev, cfg, base, labels,
                                     Path(tmp) / "crash", f, m22),
        lambda f: trainer_for(torch, dev, cfg, base, labels,
                              Path(tmp) / "crash", f, m14))
    out = {}
    for name, tr, o in (("full", full, fout), ("resumed", res, rout)):
        whole = tr.sharded.gather(tr.state)
        out[name] = {"loss": [m["loss"] for m in o["metrics"]],
                     "assign": whole["assign"].cpu(),
                     "params": {k: v.cpu() for k, v in
                                whole["params"].items()},
                     "rows": int(tr.state["assign"].shape[0])}
    out["seconds"] = time.perf_counter() - t0
    return out


def train_rank(rank: int, world: int, tmp: str, dev_type: str) -> None:
    """One of the DIST_P gloo ranks ``--train`` spawns for the train
    cell's (b) (``train_rank_work``). Writes its results to
    tmp/train<rank>.pt, or its traceback to tmp/err<rank>.txt."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    try:
        dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=300))
        out = train_rank_work(torch, dev, world, tmp)
        torch.save(out, Path(tmp) / f"train{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def narrow_data(torch, dev, tmp: str) -> None:
    """The narrow mesh runs' ANN data and labels (clustered_ann's recipe,
    NARROW_L x D from SEED + 7, K_NEIGH exact neighbours on the card) ->
    tmp/narrow.pt, which the spawned ranks load."""
    from repro_torch.data.synthetic import clustered_vectors
    nbase, _, _ = clustered_vectors(n_base=NARROW_L, n_queries=1, d=D,
                                    seed=SEED + 7)
    nbase = torch.from_numpy(nbase).to(dev)
    nlabels = neighbours(torch, dev, nbase, nbase, K_NEIGH)
    torch.save({"base": nbase.cpu(), "labels": nlabels.cpu()},
               Path(tmp) / "narrow.pt")


def tma_case(torch, dev, kernel):
    """(fn, args) of one TMA kernel's toy call (tests/test_torch_cuda.py's
    thread test): the analysis fixtures for mega_query (R = 2, Q = 6),
    irli_topk and distance_topk, a bf16 flash_attention [1, 2, 256, 64]."""
    from repro_torch.analysis import fixtures as FX
    from repro_torch.analysis.contracts import on_device
    from repro_torch.kernels.flash_attention import ops as faops
    with on_device(dev):
        if kernel == "flash_attention":
            g = torch.Generator(device=dev).manual_seed(SEED)
            return faops.flash_attention, tuple(
                torch.randn(1, 2, 256, 64, device=dev, generator=g)
                .bfloat16() for _ in range(3))
        fx = {"mega_query": FX.mega_store_search,
              "irli_topk": FX.irli_topk_fixture,
              "distance_topk": FX.distance_topk_fixture}[kernel]()
    return fx.fn, fx.args


def thread_phase(torch, dev) -> dict:
    """Each TMA kernel (TMA_KERNELS): THREAD_MAIN launches of its toy call
    and THREAD_IRLI of irli_topk's in this thread, then THREAD_CALLS of the
    same call from a new thread that never sets a device (its first CUDA
    call is the launch): every result bit-equal to this thread's. Before
    kernels/tma.cuh bound the thread's context first, mega_query and
    irli_topk returned cudaError 1 there and flash_attention 801."""
    import threading

    from repro_torch.kernels import LAUNCHES, reset_launches

    def flat(r):
        return [r] if isinstance(r, torch.Tensor) else [
            t for x in r for t in flat(x)]

    irli_fn, irli_args = tma_case(torch, dev, "irli_topk")
    out = {}
    for kernel in TMA_KERNELS:
        fn, args = tma_case(torch, dev, kernel)
        want = flat(fn(*args))
        for _ in range(THREAD_MAIN):
            fn(*args)
        for _ in range(THREAD_IRLI):
            irli_fn(*irli_args)
        torch.cuda.synchronize()
        reset_launches()
        got = {}

        def worker():
            try:
                got["calls"] = [flat(fn(*args)) for _ in range(THREAD_CALLS)]
                torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001  (raised below)
                got["err"] = e

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=120)
        if t.is_alive() or "err" in got:
            raise AssertionError(f"{kernel} from a new thread: "
                                 f"{got.get('err', 'hung')!r}")
        equal = all(torch.equal(a, b) for call in got["calls"]
                    for a, b in zip(call, want))
        if not equal or LAUNCHES[kernel] != THREAD_CALLS:
            raise AssertionError(f"{kernel} from a new thread: bit-equal "
                                 f"{equal}, launches {LAUNCHES[kernel]}")
        out[kernel] = LAUNCHES[kernel]
    log(f"train cell (e): a new thread that set no device, after "
        f"{THREAD_MAIN} launches of each kernel's toy call and {THREAD_IRLI} "
        f"of irli_topk's here, launched each {THREAD_CALLS} times, every "
        f"result bit-equal to this thread's: {out}")
    return out


def retrieval_phase(torch, dev) -> dict:
    """(c) build_retrieval_serve at DIEN's retrieval_cand: query [1, 36]
    against the item table [N_CANDIDATES, 36] fp32, k = 100 (random, from
    SEED, on the card): one distance_topk launch ("dot"), held to its plain
    version (ids equal outside near ties at the k cut, scores to TOL),
    timed beside the plain version, torch.topk over torch.mm and its byte
    bound."""
    from repro_torch.configs import recsys_common as RC
    from repro_torch.configs.dien import RETRIEVAL_DIM
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.distance_topk.ref import distance_topk_ref
    from repro_torch.launch.steps import build_retrieval_serve

    shapes = RC.retrieval_shapes(RETRIEVAL_DIM)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.randn(shapes["item_table"], generator=gen, device=dev)
    query = torch.randn(shapes["query"], generator=gen, device=dev)
    k = shapes["k"]
    step = build_retrieval_serve(k)
    params, batch = {"item_table": {"table": table}}, {"query": query}
    torch.cuda.synchronize()
    reset_launches()
    out = step(params, batch)
    torch.cuda.synchronize()
    launches = {n: c for n, c in LAUNCHES.items() if c}
    if launches != {"distance_topk": 1}:
        raise AssertionError(f"build_retrieval_serve launched {launches}")
    every = torch.ones((1, table.shape[0]), dtype=torch.bool, device=dev)
    err = dist_check(torch, "retrieval_cand (build_retrieval_serve)",
                     out["scores"], out["ids"], query, table, every, k)
    ms = time_ms(torch, lambda: step(params, batch))
    plain = time_ms(torch, lambda: distance_topk_ref(query, table, every,
                                                     k=k), n=5)
    lib = time_ms(torch, lambda: torch.topk(torch.mm(query, table.T), k))
    from repro_torch.kernels.distance_topk import ops as dops
    # as before: the shared mask row (N bytes) is not counted
    c = dops.cost(query.shape[0], *table.shape, k, mask_rows=0)
    bound_ms, by = bound(c["flops"], c["bytes"])
    log(f"train cell (c) retrieval_cand: query {tuple(query.shape)} x item "
        f"table {tuple(table.shape)} fp32, k={k}: build_retrieval_serve "
        f"{ms:.4f} ms (one distance_topk launch), plain version "
        f"{plain:.4f} ms, torch.topk(torch.mm) {lib:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by}); max |err| {err:.3g}")
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound_ms}


def train_cell(torch, dev, ranks=None) -> dict:
    """The train cell (train/trainer.py, train/elastic.py, launch/steps.
    build_irli_fit_parts and build_retrieval_serve, launch/obs_smoke):
    (a) the Trainer over build_irli_fit_parts at the fit cell's config
        (deep1b widths D = 96, H = 1024, B = 20,000; sigmoid_bce, K = 10,
        ANN mode; L = N = FIT_L, batch FIT_BATCH) with R cut to TRAIN_R:
        TRAIN_ROUNDS rounds of 1 epoch, a checkpoint every TRAIN_EVERY,
        uninterrupted, then crashed before round TRAIN_FAIL and resumed:
        assign, params and the last round's loss bit-equal; per round one
        bce_logits launch a step, one irli_topk a label chunk, one kchoice;
    (b) the mesh Trainer on DIST_P gloo ranks sharing the card at the
        narrow widths (B = 2000, R = 4, H = 256, NARROW_L labels):
        uninterrupted on 2 x 2, crashed and resumed on 1 x 4, the resumed
        run held to the uninterrupted one with the mesh fit's tolerances
        (last loss rtol 1e-4, assign match > 0.98, params rtol 1e-3).
        ``ranks``: the distributed cell's ranks' train_rank_work results;
        None spawns DIST_P ranks for it here (``--train``);
    (c) retrieval_phase; (d) launch/obs_smoke.main(device="cuda"), its own
        asserts; (e) thread_phase."""
    import shutil
    import tempfile

    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.fit.engine import FitEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import obs_smoke

    t_cell = time.perf_counter()
    launches = {}
    # ------------------------------------------ (a) one card, R = TRAIN_R --
    t0 = time.perf_counter()
    base, _, _ = clustered_vectors(n_base=FIT_L, n_queries=1, d=D,
                                   seed=SEED)
    base = torch.from_numpy(base).to(dev)
    labels = neighbours(torch, dev, base, base, K_NEIGH)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    cfg = train_config()
    root = Path(__file__).resolve().parent / "build" / "train_cell"
    shutil.rmtree(root, ignore_errors=True)
    reset_launches()
    full = trainer_for(torch, dev, cfg, base, labels, root / "full")
    fout = full.run()
    full_launch = {n: c for n, c in LAUNCHES.items() if c}
    res, rout = crash_and_resume(torch, lambda f: trainer_for(
        torch, dev, cfg, base, labels, root / "crash", f))
    torch.cuda.synchronize()
    launches["train"] = {n: c for n, c in LAUNCHES.items() if c}
    steps = FitEngine(cfg, None).batch_plan(FIT_L)[0]
    rounds = TRAIN_ROUNDS + TRAIN_FAIL + (TRAIN_ROUNDS - TRAIN_FAIL)
    want = {"bce_logits": steps * rounds,
            "irli_topk": -(-FIT_L // FIT_CHUNK) * rounds, "kchoice": rounds}
    if launches["train"] != want:
        raise AssertionError(f"the train cell launched {launches['train']}, "
                             f"expected {want}")
    same = (torch.equal(full.state["assign"], res.state["assign"])
            and all(torch.equal(full.state["params"][n],
                                res.state["params"][n])
                    for n in full.state["params"])
            and fout["metrics"][-1]["loss"] == rout["metrics"][-1]["loss"])
    npz = root / "crash" / f"step_{TRAIN_ROUNDS - 1:012d}" / "arrays.npz"
    nbytes = npz.stat().st_size
    for m in fout["metrics"]:
        log(f"train cell (a) round {m['step']}: {m['step_time_s']:.3f} s "
            f"(after torch.cuda.synchronize), loss {m['loss']:.6f}, "
            f"reassigned {m['n_reassigned']:.0f}, load std "
            f"{m['load_std']:.4f}, max {m['load_max']:.0f}")
    log(f"train cell (a) Trainer over build_irli_fit_parts, deep1b widths "
        f"with R={TRAIN_R} (of {R}), L = N = {FIT_L}, batch {FIT_BATCH}, "
        f"{TRAIN_ROUNDS} rounds of {steps} steps: data {data_s:.2f} s; "
        f"checkpoint writes {[round(s, 3) for s in full.save_seconds]} s "
        f"(uninterrupted) and {[round(s, 3) for s in res.save_seconds]} s "
        f"(resumed), restore {res.restore_seconds:.3f} s, "
        f"{nbytes} bytes of arrays.npz a checkpoint; crash before round "
        f"{TRAIN_FAIL} and resume: assign, params and round "
        f"{TRAIN_ROUNDS - 1}'s loss bit-equal to the uninterrupted run: "
        f"{same}; launches {launches['train']} (uninterrupted "
        f"{full_launch}); straggler "
        f"rounds {fout['straggler_steps']}")
    if not same:
        raise AssertionError("the resumed fit differs from the "
                             "uninterrupted one")
    round_s = [m["step_time_s"] for m in fout["metrics"]]
    del full, res, base, labels
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---------------------------------- (b) the mesh Trainer, 4 ranks --
    where = "the distributed cell's ranks"
    if ranks is None:
        where = "ranks spawned here"
        tmp = tempfile.mkdtemp(prefix="irli_train_")
        narrow_data(torch, dev, tmp)
        torch.cuda.synchronize()
        spawn_ranks(train_rank, DIST_P, tmp, dev.type, timeout=300)
        ranks = [torch.load(Path(tmp) / f"train{r}.pt")
                 for r in range(DIST_P)]
        shutil.rmtree(tmp, ignore_errors=True)
    for rk in ranks[1:]:
        for name in ("full", "resumed"):
            if rk[name]["loss"] != ranks[0][name]["loss"] or not torch.equal(
                    rk[name]["assign"], ranks[0][name]["assign"]):
                raise AssertionError(f"train cell (b): the ranks' {name} "
                                     f"runs disagree")
    full, resumed = ranks[0]["full"], ranks[0]["resumed"]
    loss_rel = abs(resumed["loss"][-1] - full["loss"][-1]) / abs(
        full["loss"][-1])
    match = float((resumed["assign"] == full["assign"]).float().mean())
    prel = max(float(((resumed["params"][n] - full["params"][n]).abs()
                      - 1e-3 * full["params"][n].abs()).max())
               for n in full["params"])
    log(f"train cell (b) mesh Trainer on {DIST_P} gloo ranks sharing the "
        f"card (B={NARROW['n_buckets']}, R={NARROW['n_reps']}, "
        f"H={NARROW['d_hidden']}, {NARROW_L} labels, {TRAIN_ROUNDS} rounds): "
        f"rep rows a rank {full['rows']} on 2 x 2, {resumed['rows']} on "
        f"1 x 4; last loss {resumed['loss'][-1]:.6f} resumed against "
        f"{full['loss'][-1]:.6f} uninterrupted (rel {loss_rel:.3g}), assign "
        f"match {match:.4f}, params |diff| - 1e-3|ref| at most {prel:.3g}; "
        f"{ranks[0]['seconds']:.1f} s on {where} (correctness only)")
    if not (loss_rel <= 1e-4 and match > 0.98 and prel <= 1e-5):
        raise AssertionError("train cell (b): the resumed 1 x 4 run is off "
                             "the uninterrupted 2 x 2 run's tolerances")
    # --------------------------------------- (c) retrieval, (d), (e) --
    retrieval = retrieval_phase(torch, dev)
    launches["retrieval"] = retrieval.pop("launches")
    t0 = time.perf_counter()
    reset_launches()
    obs_smoke.main(device="cuda")
    torch.cuda.synchronize()
    launches["obs_smoke"] = {n: c for n, c in LAUNCHES.items() if c}
    log(f"train cell (d) launch/obs_smoke.main(device='cuda'): "
        f"{time.perf_counter() - t0:.2f} s, every family asserted; "
        f"launches {launches['obs_smoke']}")
    threads = thread_phase(torch, dev)
    log(f"train cell: {time.perf_counter() - t_cell:.1f} s")
    return {"launches": launches, "round_s": round_s, "bytes": nbytes,
            "retrieval": retrieval, "threads": threads}


# --------------------------------------------------------- model training --
TRAIN_SEQ = 4096                  # train_4k's sequence
GEMMA_TRAIN_LAYERS = 4            # of 28: params, grads, m, v, acc ~30 GB
MIXTRAL_TRAIN_LAYERS = 2          # of 32: ~51 GB of state
GEMMA_TRAIN_STEPS = 4             # a warm step, two timed, one traced
TRAIN_LR = 1e-4
DLRM_TABLE_CAP = 2_000_000        # the five 40M-row tables, cut
CTR_BATCH = {"dlrm": 65_536, "xdeepfm": 16_384, "bst": 65_536,
             "dien": 8_192}
REDDIT_NODES, REDDIT_EDGES = 232_965, 11_648_250   # mean degree 50
FANOUT, SEEDS = (15, 10), 1024
PARITY_TOL = 1e-4                 # card vs CPU, of a leaf's largest |g|
MODEL_ARCHS = ("gemma-7b", "yi-6b", "qwen3-4b", "mixtral-8x7b",
               "llama4-maverick-400b-a17b", "schnet", "dlrm")


def tree_max_err(torch, got, want, zero_leaf=1e-4) -> float:
    """The largest |a - b| of two trees of tensors (one nesting), each
    leaf over its own largest |b| (floored at ``zero_leaf`` of the tree's
    largest: a leaf whose exact gradient is 0, such as an attention bias
    before a softmax, is rounding noise)."""
    from repro_torch.checkpoint.checkpointer import flatten_with_paths
    a = [t.float().cpu() for _, t in flatten_with_paths(got)]
    b = [t.float().cpu() for _, t in flatten_with_paths(want)]
    top = max(float(t.abs().max()) for t in b)
    return max(float((x - y).abs().max())
               / max(float(y.abs().max()), zero_leaf * top, 1e-30)
               for x, y in zip(a, b))


def train_steps(torch, step, state, batch, n: int = 3, trace=None):
    """n steps of one train step on one repeated batch: step 0 warm (its
    loss kept), the others timed with CUDA events; with ``trace`` the last
    one runs under ``device_split`` instead (no extra step; give n >= 4 so
    that two steps are timed). -> (state, losses,
    ms of each timed step, peak GB, launches of all n, split or None)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times, split = [], [], None
    for i in range(n):
        if trace is not None and i == n - 1:
            holder = {}

            def run():
                holder["out"] = step(state, batch)
            split = device_split(torch, run, trace, "kernels", warm=False,
                                 require=False)
            state, m = holder["out"]
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch)
            end.record()
            end.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return state, losses, times, peak, launches, split


def fwd_bwd_ms(torch, loss_fn, leaves, n: int = 3) -> float:
    """CUDA-event median of loss_fn() and its gradient in ``leaves``."""
    def run():
        with torch.enable_grad():
            torch.autograd.grad(loss_fn(), leaves)
    return time_ms(torch, run, n=n, warmup=1)


def lm_shares(torch, dev, tree, cfg, labels, step_ms) -> dict:
    """What a step at [1, TRAIN_SEQ] microbatches spends, measured alone
    with CUDA events: the fp32 tied head (``chunked_xent`` forward and
    backward, its chunk recomputed, as in the step) and one layer's
    attention (``attend_train`` forward and backward plus the forward the
    layer's remat adds; the projections included) -> ms and shares of
    the step (2 microbatches, every layer)."""
    from repro_torch.models.attention import attend_train
    from repro_torch.models.transformer import chunked_xent
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    x = torch.randn((1, TRAIN_SEQ, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16).requires_grad_(True)
    table = tree["embed"]["table"]
    mask = torch.ones((1, TRAIN_SEQ), device=dev)
    table.requires_grad_(True)
    try:
        head = fwd_bwd_ms(torch, lambda: chunked_xent(
            tree, cfg, x, labels[:1], mask), [x, table])
    finally:
        table.requires_grad_(False)
    p = tree["layers"]["0"]["attn"]
    acfg = cfg.attn_cfg(0)
    ws = [t for v in p.values() for t in v.values()]
    for t in ws:
        t.requires_grad_(True)
    try:
        attn_fb = fwd_bwd_ms(torch, lambda: attend_train(
            p, acfg, x).float().sum(), [x, *ws])
        with torch.enable_grad():
            attn_f = time_ms(torch, lambda: attend_train(p, acfg, x), n=3,
                             warmup=1)
    finally:
        for t in ws:
            t.requires_grad_(False)
    n_att = 2 * cfg.n_layers
    return {"head_ms": head, "head_share": 2 * head / step_ms,
            "attention_ms": attn_fb + attn_f,
            "attention_share": n_att * (attn_fb + attn_f) / step_ms}


def split_line(split) -> str:
    total, parts = split[0], split[1]
    top = ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f}%)"
                    for k, v in list(parts.items())[:6])
    return f"traced {total:.1f} ms of device time: {top}"


def lm_train_phase(torch, dev) -> dict:
    """(a) gemma-7b at full width, GEMMA_TRAIN_LAYERS layers, and (b)
    mixtral-8x7b at full width, MIXTRAL_TRAIN_LAYERS layers under both
    routers: build_lm_train_step (adamw_nomaster, n_micro = 2) on a global
    batch of 2 x TRAIN_SEQ random tokens (next-token labels)."""
    import dataclasses

    from repro_torch.configs import gemma_7b, mixtral_8x7b
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.launch.steps import build_lm_train_step, lm_grads
    from repro_torch.models.module import param_count, tensor_tree
    from repro_torch.models.transformer import lm_init, lm_loss
    from repro_torch.optim.optimizers import global_norm

    out = {"launches": {}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)

    def batch_of(cfg):
        t = torch.randint(0, cfg.vocab, (2, TRAIN_SEQ), generator=gen,
                          device=dev, dtype=torch.int32)
        return {"tokens": t, "labels": torch.roll(t, -1, 1)}

    # ------------------------------------------------------ (a) gemma --
    t_ph = time.perf_counter()
    cfg = dataclasses.replace(gemma_7b.CONFIG,
                              n_layers=GEMMA_TRAIN_LAYERS)
    tree = tensor_tree(lm_init(cfg, seed=SEED, device=dev))
    batch = batch_of(cfg)
    n_par = param_count(tree)
    reset_launches()
    with torch.no_grad():
        ref_loss = float(lm_loss(tree, cfg, batch["tokens"],
                                 batch["labels"])[0])
    prefill = {k: v for k, v in LAUNCHES.items() if v}
    if prefill != {"flash_attention": GEMMA_TRAIN_LAYERS}:
        raise AssertionError(f"gemma no-grad loss: launches {prefill}")
    # the whole batch as one microbatch; the first step's grad_norm (at
    # n_micro = 2, from the same params) is held to it
    torch.cuda.reset_peak_memory_stats()
    _, g = lm_grads(tree, cfg, batch["tokens"], batch["labels"], 1)
    norm1 = float(global_norm(g))
    del g
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    step, opt = build_lm_train_step(cfg, "adamw_nomaster", n_micro=2,
                                    lr=TRAIN_LR)
    state = {"params": tree, "opt": opt.init(tree)}
    norm2 = []
    plain_step = step

    def step(st, b):
        st, m = plain_step(st, b)
        norm2.append(float(m["grad_norm"]))
        return st, m
    state, losses, times, peak, launches, split = train_steps(
        torch, step, state, batch, n=GEMMA_TRAIN_STEPS,
        trace=("flash", "kchoice"))
    rel = abs(norm1 - norm2[0]) / norm2[0]
    log(f"model train (a) gemma grad_norm at n_micro 1 {norm1:.6f} (peak "
        f"{peak1:.2f} GB), the first step's at n_micro 2 {norm2[0]:.6f}")
    if rel > 1e-3:
        raise AssertionError(f"gemma grad_norm at n_micro 1 and 2: {norm1}, "
                             f"{norm2[0]}")
    if launches.get("flash_attention", 0):
        raise AssertionError(f"gemma train step launched flash_attention: "
                             f"{launches}")
    if abs(losses[0] - ref_loss) > 1e-2 * abs(ref_loss):
        raise AssertionError(f"gemma first step's loss {losses[0]} against "
                             f"the no-grad kernel loss {ref_loss}")
    ms = statistics.median(times)
    tok = 2 * TRAIN_SEQ
    log(f"model train (a) gemma-7b {GEMMA_TRAIN_LAYERS} of 28 layers, "
        f"{n_par} params bf16, adamw_nomaster lr {TRAIN_LR}, batch 2 x "
        f"{TRAIN_SEQ} as n_micro 2: losses {losses} (the no-grad loss "
        f"through flash_attention {ref_loss:.6f}, {prefill['flash_attention']}"
        f" launches; rel {abs(losses[0] - ref_loss) / ref_loss:.2e}); "
        f"grad_norm n_micro 1 vs 2 rel {rel:.2e}; step {ms:.1f} ms "
        f"({times}), {tok / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GB; "
        f"launches in {GEMMA_TRAIN_STEPS} steps {launches}; "
        f"{split_line(split)}")
    dry = dryrun_train(torch, GEMMA_DRY_LABEL, plain_step, state, batch)
    shares = lm_shares(torch, dev, tree, cfg, batch["labels"], ms)
    log(f"model train (a) gemma-7b, measured alone: the fp32 tied head "
        f"(chunked_xent forward + backward, one microbatch) "
        f"{shares['head_ms']:.1f} ms, x 2 = {shares['head_share']:.1%} of "
        f"the step; one layer's attention (attend_train forward + backward "
        f"+ the remat's forward, projections included) "
        f"{shares['attention_ms']:.1f} ms, x {2 * cfg.n_layers} = "
        f"{shares['attention_share']:.1%}")
    out["gemma"] = {"ms": ms, "times": times, "tokens_s": tok / ms * 1e3,
                    "peak_gb": peak, "losses": losses, "ref_loss": ref_loss,
                    "grad_norm_rel": rel, "split": split[1], **shares,
                    "dryrun": dry}
    out["launches"]["model train (a) no-grad loss"] = prefill
    out["launches"]["model train (a) gemma step"] = launches
    del state, tree, opt, step, batch
    torch.cuda.empty_cache()
    log(f"model train (a): {time.perf_counter() - t_ph:.1f} s")

    # ---------------------------------------------------- (b) mixtral --
    t_ph = time.perf_counter()
    kernel = kops.kchoice
    for router in ("topk", "irli_kchoice"):
        base = mixtral_8x7b.CONFIG
        cfg = dataclasses.replace(
            base, n_layers=MIXTRAL_TRAIN_LAYERS,
            moe=dataclasses.replace(base.moe, router=router))
        tree = tensor_tree(lm_init(cfg, seed=SEED, device=dev))
        batch = batch_of(cfg)
        step, opt = build_lm_train_step(cfg, "adamw_nomaster", n_micro=2,
                                        lr=TRAIN_LR)
        state = {"params": tree, "opt": opt.init(tree)}
        picks = []

        def recording(*a, **k):
            res = kernel(*a, **k)
            picks.append(res.clone())
            return res
        kops.kchoice = recording
        try:
            state, losses, times, peak, launches, _ = train_steps(
                torch, step, state, batch)
        finally:
            kops.kchoice = kernel
        if peak > 75:
            raise AssertionError(f"mixtral train peak {peak:.1f} GB")
        L_ = MIXTRAL_TRAIN_LAYERS
        want = 3 * 2 * L_ * 2 if router == "irli_kchoice" else 0
        if launches.get("kchoice", 0) != want or launches.get(
                "flash_attention", 0):
            raise AssertionError(f"mixtral {router}: launches {launches}, "
                                 f"kchoice wanted {want}")
        same = True
        for s in range(0, len(picks), 2 * L_):   # a microbatch: F.., R..
            fwd, rec = picks[s:s + L_], picks[s + L_:s + 2 * L_][::-1]
            same &= all(torch.equal(a, b) for a, b in zip(fwd, rec))
        if not same:
            raise AssertionError(f"mixtral {router}: a recompute routed "
                                 f"otherwise than its forward")
        ms = statistics.median(times)
        tok = 2 * TRAIN_SEQ
        aux = "" if router == "irli_kchoice" else " (aux in the loss)"
        log(f"model train (b) mixtral-8x7b {L_} of 32 layers, router "
            f"{router}{aux}: losses {losses}; step {ms:.1f} ms ({times}), "
            f"{tok / ms * 1e3:.0f} tokens/s, peak {peak:.2f} GB; launches "
            f"in 3 steps {launches}"
            + (f" (one a layer a microbatch forward plus one a recompute; "
               f"each recompute's assignment bit-equal to its forward's: "
               f"{same})" if want else ""))
        out[f"mixtral_{router}"] = {"ms": ms, "times": times,
                                    "tokens_s": tok / ms * 1e3,
                                    "peak_gb": peak, "losses": losses}
        out["launches"][f"model train (b) mixtral {router}"] = launches
        del state, tree, opt, step, batch, picks
        torch.cuda.empty_cache()
    log(f"model train (b): {time.perf_counter() - t_ph:.1f} s")
    return out


def ctr_train_phase(torch, dev) -> dict:
    """(c) DLRM (MLPerf widths, the 40M-row tables cut to DLRM_TABLE_CAP),
    xDeepFM, BST and DIEN at their CONFIGs through build_ctr_train_step
    (adamw_nomaster), 3 steps each on one repeated batch of CTR_BATCH."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import bst, dien, xdeepfm
    from repro_torch.data.synthetic import behavior_stream, criteo_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.steps import (build_ctr_serve,
                                          build_ctr_train_step)
    from repro_torch.models import recsys as RS
    from repro_torch.models.module import param_count, tensor_tree

    out = {"launches": {}}
    rng = np.random.default_rng(SEED)

    def on(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def run(name, params, apply, batch, extra=""):
        step, opt = build_ctr_train_step(apply, lr=TRAIN_LR)
        state = {"params": params, "opt": opt.init(params)}
        state, losses, times, peak, launches, _ = train_steps(
            torch, step, state, batch)
        ms = statistics.median(times)
        bsz = CTR_BATCH[name]
        log(f"model train (c) {name} at batch {bsz}: {param_count(params)} "
            f"params; losses {losses}; step {ms:.2f} ms ({times}), "
            f"{bsz / ms * 1e3:.0f} samples/s, peak {peak:.2f} GB; launches "
            f"{launches}{extra}")
        out[name] = {"ms": ms, "times": times, "samples_s": bsz / ms * 1e3,
                     "peak_gb": peak, "losses": losses}
        out["launches"][f"model train (c) {name} step"] = launches
        return state, launches

    # DLRM: MLPerf widths, each 40M-row table cut to DLRM_TABLE_CAP rows
    t_ph = time.perf_counter()
    vocab = tuple(min(v, DLRM_TABLE_CAP) for v in RS.DLRMConfig().vocab_sizes)
    pad = (-sum(vocab)) % 512
    padded = vocab[:-1] + (vocab[-1] + pad,)
    cfg = dataclasses.replace(RS.DLRMConfig(), vocab_sizes=padded)
    params, offsets = RS.dlrm_init(cfg, seed=SEED, device=dev)
    batch = on(next(criteo_stream(CTR_BATCH["dlrm"], cfg.n_dense, vocab,
                                  seed=SEED)))
    log(f"model train (c) dlrm: {sum(padded)} table rows ({sum(vocab)} "
        f"before the /512 pad; {sum(padded) * cfg.embed_dim * 4 / 1e9:.2f} "
        f"GB fp32), batch made in {time.perf_counter() - t_ph:.2f} s")
    run("dlrm", params, lambda p, b: RS.dlrm_apply(
        p, cfg, offsets, b["dense"], b["sparse"]), batch)
    del params, batch
    torch.cuda.empty_cache()

    # xDeepFM at its CONFIG
    xc = xdeepfm.CONFIG
    params, offsets = RS.xdeepfm_init(xc, seed=SEED, device=dev)
    host = next(criteo_stream(CTR_BATCH["xdeepfm"], 13,
                              [xc.vocab_per_field] * xc.n_sparse,
                              seed=SEED))
    batch = on({"sparse": host["sparse"], "label": host["label"]})
    run("xdeepfm", params, xdeepfm.apply, batch)
    del params, batch
    torch.cuda.empty_cache()

    # BST at its CONFIG
    bc = bst.CONFIG
    params = RS.bst_init(bc, seed=SEED, device=dev)
    host = next(behavior_stream(CTR_BATCH["bst"], bc.seq_len,
                                bc.item_vocab, 1, seed=SEED))
    batch = on({"hist_items": host["hist_items"],
                "target_item": host["target_item"],
                "other_ids": rng.integers(
                    0, bc.other_vocab, (CTR_BATCH["bst"], bc.n_other_feats)
                ).astype(np.int32), "label": host["label"]})
    run("bst", params, bst.apply, batch)
    del params, batch
    torch.cuda.empty_cache()

    # DIEN at its CONFIG: no embedding_bag under the gradient, the item
    # table's gradient on the histories' rows, then 2 launches to serve
    dc = dien.CONFIG
    tree = tensor_tree(RS.dien_init(dc, seed=SEED, device=dev))
    batch = on(next(behavior_stream(CTR_BATCH["dien"], dc.seq_len,
                                    dc.item_vocab, dc.cate_vocab,
                                    seed=SEED)))
    state, launches = run("dien", tree, dien.apply, batch)
    if launches.get("embedding_bag", 0):
        raise AssertionError(f"dien train step launched embedding_bag: "
                             f"{launches}")
    hist = batch["hist_items"][batch["hist_mask"] > 0].long().unique()
    only = hist[~torch.isin(hist, batch["target_item"].long())]
    m_rows = state["opt"]["m"]["item_emb"]["table"][only]
    nonzero = float((m_rows.abs().sum(1) > 0).float().mean())
    if nonzero < 1.0:
        raise AssertionError(f"dien: the item table's first moment is 0 on "
                             f"{1 - nonzero:.4f} of the history-only rows")
    reset_launches()
    prob = build_ctr_serve(dien.apply)(state["params"], batch)["prob"]
    serve = dict(LAUNCHES)
    if serve["embedding_bag"] != 2 or not bool(torch.isfinite(prob).all()):
        raise AssertionError(f"dien serve after training: launches {serve}")
    # the history sum under the gradient, alone: what an embedding_bag
    # backward kernel would take over (the rows' gather is the GRU's too)
    he = torch.randn((CTR_BATCH["dien"], dc.seq_len, 2 * dc.embed_dim),
                     device=dev, requires_grad=True)
    w = batch["hist_mask"][..., None]
    bag_ms = fwd_bwd_ms(torch, lambda: (he * w).sum(1).sum(), [he])
    del he
    log(f"model train (c) dien: 0 embedding_bag launches in the steps; the "
        f"item table's AdamW first moment nonzero on all {only.numel()} "
        f"history-only rows; the trained model served with "
        f"{serve['embedding_bag']} embedding_bag launches; the history "
        f"sum's forward + backward alone {bag_ms:.3f} ms, "
        f"{bag_ms / out['dien']['ms']:.2%} of the step")
    out["dien"]["bag_ms"] = bag_ms
    out["launches"]["model train (c) dien serve"] = {
        k: v for k, v in serve.items() if v}
    del state, tree, batch
    torch.cuda.empty_cache()
    log(f"model train (c): {time.perf_counter() - t_ph:.1f} s")
    return out


def reddit_subgraph(seed: int, nodes: int, edges: int, d_in: int,
                    n_classes: int, fanout: tuple, seeds: int) -> dict:
    """minibatch_lg's batch, made on the host (numpy, no card): a
    ``random_graph`` of ``nodes`` and ``edges``, its CSR and one fanout
    sample of ``seeds`` seeds -> {"batch" (numpy), "shape" (the sampler's
    padded nodes, edges), "n_real_nodes", "n_real_edges", "seconds"}. Run
    in a spawned process beside the cell's (a) and (b)."""
    from repro_torch.data.sampler import NeighborSampler, build_csr
    from repro_torch.data.synthetic import random_graph
    t0 = time.perf_counter()
    g = random_graph(nodes, edges, d_in, seed=seed, n_classes=n_classes)
    csr = build_csr(nodes, g["src"], g["dst"], pos=g["pos"])
    sampler = NeighborSampler(csr, fanout, seeds, seed=seed)
    sub = sampler.sample()
    batch = {"feats": g["feats"][sub["nodes"]], "src": sub["src"],
             "dst": sub["dst"], "dist": sub["dist"],
             "labels": g["labels"][sub["nodes"]],
             "node_mask": sub["node_mask"]}
    return {"batch": batch, "shape": (sampler.max_nodes, sampler.max_edges),
            "n_real_nodes": sub["n_real_nodes"],
            "n_real_edges": sub["n_real_edges"],
            "seconds": time.perf_counter() - t0}


def gnn_train_phase(torch, dev, reddit) -> dict:
    """(d) SchNet at the reference's cell shapes (configs/schnet.py): the
    cora-like full graph padded to 3,072 nodes and 10,752 edges; a fanout
    (15, 10) sample of 1,024 seeds over a reddit-sized random graph
    (169,984 nodes, 168,960 edges; ``reddit``, what ``reddit_subgraph``
    returned); 128 molecules of 30 atoms and 64 edges. 3 steps each."""
    import numpy as np

    from repro_torch.configs import schnet
    from repro_torch.data.synthetic import molecule_batch, random_graph
    from repro_torch.launch.steps import (build_gnn_energy_train,
                                          build_gnn_node_train)
    from repro_torch.models.gnn import schnet_init

    out = {"launches": {}}
    t_ph = time.perf_counter()

    def on(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def run(name, cfg, step_opt, batch, n_items, unit):
        step, opt = step_opt
        params = schnet_init(cfg, seed=SEED, device=dev)
        state = {"params": params, "opt": opt.init(params)}
        state, losses, times, peak, launches, _ = train_steps(
            torch, step, state, batch)
        ms = statistics.median(times)
        log(f"model train (d) schnet {name}: losses {losses}; step "
            f"{ms:.2f} ms ({times}), {n_items / ms * 1e3:.0f} {unit}/s, peak "
            f"{peak:.2f} GB; launches {launches}")
        out[name] = {"ms": ms, "times": times, "peak_gb": peak,
                     f"{unit}_s": n_items / ms * 1e3, "losses": losses}
        out["launches"][f"model train (d) schnet {name}"] = launches

    sh = schnet.CELL_SHAPES["full_graph_sm"]
    cfg = sh["cfg"]
    g = random_graph(sh["nodes"], sh["edges"], cfg.d_in, seed=SEED,
                     n_classes=cfg.n_out)
    N, E = sh["pad_nodes"], sh["pad_edges"]
    feats = np.zeros((N, cfg.d_in), np.float32)
    feats[:sh["nodes"]] = g["feats"]
    pad_e = lambda a, fill: np.concatenate(  # noqa: E731
        [a, np.full(E - a.shape[0], fill, a.dtype)])
    labels = np.zeros(N, np.int32)
    labels[:sh["nodes"]] = g["labels"]
    mask = (np.arange(N) < sh["nodes"]).astype(np.float32)
    batch = on({"feats": feats, "src": pad_e(g["src"], 0),
                "dst": pad_e(g["dst"], 0), "dist": pad_e(g["dist"], 1e6),
                "labels": labels, "node_mask": mask})
    run("full_graph_sm", cfg, build_gnn_node_train(cfg, lr=TRAIN_LR),
        batch, sh["nodes"], "nodes")

    sh = schnet.CELL_SHAPES["minibatch_lg"]
    cfg = sh["cfg"]
    sub = reddit
    if sub["shape"] != (sh["pad_nodes"], sh["pad_edges"]):
        raise AssertionError(f"sampler shapes {sub['shape']}")
    log(f"model train (d) minibatch_lg: random_graph {REDDIT_NODES} nodes, "
        f"{REDDIT_EDGES} edges, CSR and one fanout {FANOUT} sample of "
        f"{SEEDS} seeds ({sub['n_real_nodes']} real nodes, "
        f"{sub['n_real_edges']} real edges of {sub['shape']}) built in "
        f"{sub['seconds']:.2f} s by a host process while (a) and (b) ran; "
        f"waited {sub['waited']:.2f} s for it after (b)")
    run("minibatch_lg", cfg, build_gnn_node_train(cfg, lr=TRAIN_LR),
        on(sub["batch"]), sub["n_real_nodes"], "nodes")

    sh = schnet.CELL_SHAPES["molecule"]
    cfg = sh["cfg"]
    batch = on(molecule_batch(sh["n_graphs"], 30, 64, seed=SEED))
    run("molecule", cfg, build_gnn_energy_train(cfg, sh["n_graphs"],
                                                lr=TRAIN_LR),
        batch, sh["n_graphs"], "graphs")
    log(f"model train (d): {time.perf_counter() - t_ph:.1f} s")
    return out


def parity_phase(torch, dev) -> dict:
    """(e) one train step on the card and on the CPU from the same state
    and batch (fp32, TF32 off), for each of ``launch/step_cases``: the
    five reduced LMs of the launcher and mixtral's under the k-choice
    router, the smoke tests' DLRM, BST, xDeepFM and DIEN, both SchNet
    steps. Loss to PARITY_TOL relative, the gradient (AdamW's first
    moment / (1 - b1)) leaf by leaf to PARITY_TOL of the leaf's largest
    |g|."""
    from repro_torch.launch.step_cases import step_cases
    from repro_torch.models.module import tree_to

    t_ph = time.perf_counter()
    cpu = torch.device("cpu")
    cases = step_cases(SEED)
    worst = {}
    for name, (init, (step, opt), batch) in cases.items():
        res = {}
        p_cpu = init(cpu)                 # the card starts from these draws
        for where, params in (("card", tree_to(p_cpu, dev)),
                              ("cpu", p_cpu)):
            new, m = step({"params": params, "opt": opt.init(params)},
                          batch)
            res[where] = (float(m["loss"]), new["opt"]["m"])
        lerr = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        gerr = tree_max_err(torch, res["card"][1], res["cpu"][1])
        if lerr > PARITY_TOL or gerr > PARITY_TOL:
            raise AssertionError(f"(e) {name}: loss rel {lerr:.2e}, "
                                 f"gradient rel {gerr:.2e}")
        worst[name] = (lerr, gerr)
    log("model train (e) card = CPU, one step from the same state and "
        "batch (loss rel, largest gradient leaf error rel to its max |g|): "
        + ", ".join(f"{n} {a:.1e}/{b:.1e}" for n, (a, b) in worst.items())
        + f"; {time.perf_counter() - t_ph:.1f} s")
    return {"worst": worst}



def launcher_phase(torch, dev) -> dict:
    """(f) launch/train.py on the card for the seven model archs under
    torch.use_deterministic_algorithms(True): --steps 4, then --steps 6
    from its checkpoint (resumed=True), held bit-equal to a straight
    6-step run's final loss."""
    import shutil

    from repro_torch.launch import train as T

    t_ph = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "model_train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    torch.use_deterministic_algorithms(True)
    try:
        for arch in MODEL_ARCHS:
            def run(steps, sub):
                return T.run_model(T.parse(
                    ["--arch", arch, "--steps", str(steps), "--ckpt",
                     str(root / sub), "--device", dev.type]))
            run(4, "a")
            resumed = run(6, "a")
            straight = run(6, "b")
            a = resumed["metrics"][-1]["loss"]
            b = straight["metrics"][-1]["loss"]
            if not resumed["resumed"] or len(resumed["metrics"]) != 2 \
                    or a != b:
                raise AssertionError(f"(f) {arch}: resumed {a!r} "
                                     f"({resumed['resumed']}), straight "
                                     f"{b!r}")
            res[arch] = a
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    log(f"model train (f) launch/train.py on the card, 4 steps then a "
        f"resume to 6, the final loss bit-equal to a straight 6-step run "
        f"under deterministic algorithms: {res}; "
        f"{time.perf_counter() - t_ph:.1f} s")
    return {"final_loss": res}


def model_train_cell(torch, dev) -> dict:
    """The model-training cell: (a) gemma-7b and (b) mixtral-8x7b train
    steps at full width, (c) the four CTR models, (d) SchNet's three
    cells, (e) card = CPU at the CPU tests' sizes, (f) the launcher on the
    card. Returns each phase's numbers and the launches by path."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.configs import schnet

    t_cell = time.perf_counter()
    lg = schnet.CELL_SHAPES["minibatch_lg"]["cfg"]
    # the reddit-sized graph takes seconds of host time: a spawned process
    # builds it while the card runs (a) and (b), which the host does not
    # hold back; it has ended before (c), whose steps a busy host slows
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        reddit = pool.submit(reddit_subgraph, SEED, REDDIT_NODES,
                             REDDIT_EDGES, lg.d_in, lg.n_out, FANOUT, SEEDS)
        out = {"lm": lm_train_phase(torch, dev)}
        t0 = time.perf_counter()
        graph = reddit.result(timeout=600)
        graph["waited"] = time.perf_counter() - t0
    out["ctr"] = ctr_train_phase(torch, dev)
    out["gnn"] = gnn_train_phase(torch, dev, graph)
    out["parity"] = parity_phase(torch, dev)
    out["launcher"] = launcher_phase(torch, dev)
    launches = {}
    for part in ("lm", "ctr", "gnn"):
        launches.update(out[part].pop("launches"))
    out["launches"] = launches
    log(f"model train cell: {time.perf_counter() - t_cell:.1f} s")
    return out


# ------------------------------- 18. the registry and the LM on a mesh ------
# (a) the registry's cells on the card: the gemma-7b prefill's shape, the
# IRLI train cell's reps and batch; (b) gemma-7b's layers for train_4k on a
# one-rank mesh and its batch (the model-train cell's cut); (c) the narrow
# LM families on 4 gloo ranks: width, layers, vocabulary, batch and
# sequence, and the relative tolerance against the meshless step
REG_PREFILL = (1, 2048)
REG_TRAIN_R, REG_TRAIN_BATCH = 4, 4096
MESH_TRAIN_LAYERS, MESH_TRAIN_BATCH = 4, 2
MESH_D, MESH_LAYERS, MESH_VOCAB = 512, 4, 32_000
MESH_BATCH, MESH_SEQ, MESH_MICRO, MESH_TOL = 8, 256, 1, 1e-4
MESH_RANKS = 4
# the mixtral-like family's MoE ffn_chunk: below its 8 x 256 tokens, so
# its microbatches take the per-row dispatch (moe._moe_rows, the path of
# train_4k's microbatches at full size) in 2 sequence chunks of 1024 // 8
MESH_ROWS_CHUNK = 1024


@contextlib.contextmanager
def module_values(mod, **values):
    """Set module-level values for a block (a config cut) and restore
    them."""
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def tree_equal(torch, a, b) -> bool:
    """Two nested dicts (or tensors) bit-equal, leaf for leaf."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(torch, a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


def registry_phase(torch, dev, mesh) -> dict:
    """(a) repro_torch.configs.registry on the card: all_cells() logged
    (42 cells, each arch's cells and skip reasons), then one call of each
    of these cells' own steps, built through get_arch(...).cells[...]
    (step(mesh) where step_with_mesh), on random inputs of the cell's
    shapes (cut where one card cannot hold them, each cut logged), held
    bit-equal to the direct builder's output on the same inputs, with its
    kernels' launches as counted: gemma-7b prefill_32k, dien serve_p99 and
    retrieval_cand, irli-deep1b serve_query and train_scorers."""
    import dataclasses

    from repro_torch.configs import dien as DIEN
    from repro_torch.configs import irli_deep1b as IRLI
    from repro_torch.configs import registry as REG
    from repro_torch.configs.gemma_7b import CONFIG as GEMMA
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import scorer_init
    from repro_torch.data.synthetic import behavior_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as S
    from repro_torch.models.recsys import dien_init
    from repro_torch.models.transformer import lm_init
    from repro_torch.store.quantized import encode

    t_ph = time.perf_counter()
    cells = REG.all_cells()
    if len(cells) != 42:
        raise AssertionError(f"(a) registry: {len(cells)} cells, not 42")
    for name in REG.ARCHS:
        arch = REG.get_arch(name)
        log(f"registry (a) {name} ({arch.family}, {arch.opt}): " + ", ".join(
            c + (f" [skip: {d.skip}]" if d.skip else "")
            for c, d in arch.cells.items()))
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    launches, rows = {}, {}

    def run(label, cell_call, direct_call, want):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = cell_call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {n: c for n, c in LAUNCHES.items() if c}
        ref = direct_call()
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError(f"(a) {label}: launches {got}, want {want}")
        if not tree_equal(torch, out, ref):
            raise AssertionError(f"(a) {label}: the registry's step and the "
                                 f"direct builder's differ")
        for n, c in got.items():
            launches[n] = launches.get(n, 0) + c
        rows[label] = round(ms, 1)
        log(f"registry (a) {label}: bit-equal to the direct builder, "
            f"launches {got}, {ms:.1f} ms (the first call)")
        return out

    # gemma-7b prefill_32k, [32, 32768] cut to REG_PREFILL, all 28 layers
    cell = REG.get_arch("gemma-7b").cells["prefill_32k"]
    shape = tuple(cell.inputs(mesh)["tokens"].shape)
    model = lm_init(GEMMA, seed=SEED, device=dev)
    tokens = torch.randint(0, GEMMA.vocab, REG_PREFILL, generator=gen,
                           device=dev, dtype=torch.int32)
    log(f"registry (a) gemma-7b prefill_32k: tokens {shape} cut to "
        f"{REG_PREFILL} (one card), {GEMMA.n_layers} layers")
    step = cell.step()
    run("gemma-7b prefill_32k", lambda: step(model, {"tokens": tokens}),
        lambda: S.build_lm_prefill(GEMMA)(model, {"tokens": tokens}),
        {"flash_attention": GEMMA.n_layers})
    del model, step
    torch.cuda.empty_cache()

    # dien serve_p99 (512) and retrieval_cand (1,048,576 x 36)
    arch = REG.get_arch("dien")
    params = dien_init(DIEN.CONFIG, seed=SEED, device=dev)
    cell = arch.cells["serve_p99"]
    bsz = cell.inputs(mesh)["label"].shape[0]
    host = next(behavior_stream(bsz, DIEN.CONFIG.seq_len,
                                DIEN.CONFIG.item_vocab, DIEN.CONFIG.cate_vocab,
                                seed=SEED))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    step = cell.step()
    run(f"dien serve_p99 [{bsz}]", lambda: step(params, batch),
        lambda: S.build_ctr_serve(DIEN.apply)(params, batch),
        {"embedding_bag": 2})
    cell = arch.cells["retrieval_cand"]
    tshape = tuple(cell.params(mesh)["item_table"]["table"].shape)
    table = {"item_table": {"table": torch.randn(tshape, generator=gen,
                                                 device=dev)}}
    query = {"query": torch.randn(tuple(cell.inputs(mesh)["query"].shape),
                                  generator=gen, device=dev)}
    step = cell.step()
    run(f"dien retrieval_cand {tshape}", lambda: step(table, query),
        lambda: S.build_retrieval_serve()(table, query),
        {"distance_topk": 1})
    del params, batch, table, step
    torch.cuda.empty_cache()

    # irli-deep1b serve_query: the corpus cut from 2^27 rows to the search
    # cell's L through the cell's own params(mesh) shapes
    arch = REG.get_arch("irli-deep1b")
    cell = arch.cells["serve_query"]
    with module_values(IRLI, N_CORPUS=L):
        shapes = cell.params(mesh)
    corpus, _ = serve_data(torch, dev)
    store8 = encode(corpus, "int8", BLOCK)
    del corpus
    idx = IRLIIndex(IRLIConfig(d=D, n_labels=L, n_buckets=B, n_reps=R,
                               d_hidden=H, seed=SEED), device=dev)
    idx.build_index()
    local = {"scorer": idx.params, "members": idx.index.members,
             "base_codes": store8.codes, "base_scales": store8.scales}
    for k in ("members", "base_codes", "base_scales"):
        want = tuple(shapes[k].shape)
        if (1,) + tuple(local[k].shape) != want or \
                local[k].dtype != shapes[k].dtype:
            raise AssertionError(f"(a) serve_query {k}: {local[k].dtype} "
                                 f"{tuple(local[k].shape)}, the cell "
                                 f"declares {shapes[k].dtype} {want}")
    qshape = tuple(cell.inputs(mesh)["queries"].shape)
    queries = torch.randn(qshape, generator=gen, device=dev)
    queries /= queries.norm(dim=1, keepdim=True)
    log(f"registry (a) irli-deep1b serve_query: corpus cut from "
        f"{IRLI.N_CORPUS:,} to {L:,} rows ({shapes['members'].shape} "
        f"members, {shapes['base_codes'].shape} int8 codes), queries "
        f"{qshape}")
    step = cell.step(mesh)
    run("irli-deep1b serve_query", lambda: step(local, {"queries": queries}),
        lambda: S.build_irli_serve(
            mesh, m=5, tau=2, k=10, store_dtype=IRLI.STORE_DTYPE,
            store_block=IRLI.STORE_BLOCK)(local, {"queries": queries}),
        {"irli_topk": 1, "freq_topc": 1, "quant_rerank": 1})
    del idx, store8, local, queries, step
    torch.cuda.empty_cache()

    # irli-deep1b train_scorers: R and the batch cut (its loss is
    # softmax_bce, plain torch: no kernel)
    cell = arch.cells["train_scorers"]
    cut = dataclasses.replace(IRLI.SCORER_CFG, n_reps=REG_TRAIN_R)
    with module_values(IRLI, R=REG_TRAIN_R, N_CORPUS=L, SCORER_CFG=cut):
        shapes = cell.inputs(mesh)
        step = cell.step()
    log(f"registry (a) irli-deep1b train_scorers: R cut from {IRLI.R} to "
        f"{REG_TRAIN_R}, the batch from {shapes['x'].shape[0]:,} to "
        f"{REG_TRAIN_BATCH:,}, the corpus to {L:,} labels ({cut.loss})")
    nb = REG_TRAIN_BATCH
    batch = {"x": torch.randn((nb, D), generator=gen, device=dev),
             "label_ids": torch.randint(0, L, (nb, K_NEIGH), generator=gen,
                                        device=dev, dtype=torch.int32),
             "label_mask": torch.ones((nb, K_NEIGH), device=dev),
             "assign": torch.randint(0, B, tuple(shapes["assign"].shape),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    direct, opt = S.build_irli_train_step(cut, B)

    def fresh():
        p = scorer_init(cut, torch.Generator(device=dev).manual_seed(SEED))
        return {"params": p, "opt": opt.init(p)}

    def train_out(fn):
        state, metrics = fn(fresh(), batch)
        return {"state": state["params"], "loss": metrics["loss"]}

    torch.use_deterministic_algorithms(True)
    try:
        run("irli-deep1b train_scorers", lambda: train_out(step),
            lambda: train_out(direct), {})
    finally:
        torch.use_deterministic_algorithms(False)
    del batch, step, direct
    torch.cuda.empty_cache()
    log(f"registry (a): {time.perf_counter() - t_ph:.1f} s, launches "
        f"{launches}")
    return {"launches": launches, "ms": rows}


def mesh_train_phase(torch, dev, mesh) -> dict:
    """(b) gemma-7b's train_4k cell through the registry on the one-rank
    NCCL mesh: full width, MESH_TRAIN_LAYERS of 28 layers, the batch cut
    from 256 to MESH_TRAIN_BATCH x 4096; the state placed as DTensors by
    lm_rules and opt_state_specs (each holding its tensor's storage), two
    steps of the cell's step(mesh) held to two meshless steps of the same
    config from the same state (loss and grad_norm within 1e-5 relative),
    every leaf's placements kept; both step times (CUDA-synchronized wall
    time: the difference is DTensor's overhead at world size 1)."""
    import dataclasses

    from repro_torch.configs import gemma_7b as G
    from repro_torch.configs.base import dp
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as S
    from repro_torch.models.module import (flatten_with_paths, place,
                                           tensor_tree)
    from repro_torch.models.transformer import lm_init

    t_ph = time.perf_counter()
    cut = dataclasses.replace(G.CONFIG, n_layers=MESH_TRAIN_LAYERS)
    with module_values(G, CONFIG=cut):
        arch = G.get_arch()
    cell = arch.cells["train_4k"]
    seq = cell.inputs(mesh)["tokens"].shape[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    host = {k: torch.randint(0, cut.vocab, (MESH_TRAIN_BATCH, seq),
                             generator=gen, device=dev, dtype=torch.int32)
            for k in ("tokens", "labels")}
    opt = S.make_opt(arch.opt, **arch.opt_kw)

    def fresh():
        params = tensor_tree(lm_init(cut, seed=SEED, device=dev))
        return params, {"params": params, "opt": opt.init(params)}

    def steps(step, state, batch):
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        (time.perf_counter() - t0) * 1e3))
        return state, out

    _, state = fresh()
    plain, _ = S.build_lm_train_step(cut, arch.opt, **arch.opt_kw)
    state, want = steps(plain, state, host)
    del state, plain
    torch.cuda.empty_cache()
    params, state = fresh()
    pspecs = arch.rules().specs(params)
    placed = S.place_train_state(
        state, pspecs, S.opt_state_specs(arch.opt, params, pspecs, mesh),
        mesh)
    shared = all(t.to_local().data_ptr() == w.data_ptr() for (_, t), (_, w)
                 in zip(flatten_with_paths(placed["params"]),
                        flatten_with_paths(params)))
    before = {p: tuple(t.placements) for p, t in flatten_with_paths(placed)
              if hasattr(t, "placements")}
    specs = cell.in_specs(mesh)
    batch = {k: place(v, specs[k], mesh) for k, v in host.items()}
    step = cell.step(mesh)
    reset_launches()
    placed, got = steps(step, placed, batch)
    launches = {n: c for n, c in LAUNCHES.items() if c}
    after = {p: tuple(t.placements) for p, t in flatten_with_paths(placed)
             if hasattr(t, "placements")}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    for (wl, wg, _), (gl, gg, _) in zip(want, got):
        if abs(gl - wl) > 1e-5 * abs(wl) or abs(gg - wg) > 1e-5 * abs(wg):
            raise AssertionError(f"(b) mesh step {(gl, gg)} against the "
                                 f"meshless {(wl, wg)}")
    if before != after or not shared or launches:
        raise AssertionError(f"(b) placements kept {before == after}, "
                             f"storage shared {shared}, launches "
                             f"{launches}")
    del placed, params, state, batch, step
    torch.cuda.empty_cache()
    log(f"mesh (b) gemma-7b train_4k through the registry on a 1 x 1 NCCL "
        f"mesh, {MESH_TRAIN_LAYERS} of 28 layers, batch {MESH_TRAIN_BATCH} x "
        f"{seq} (dp {dp(mesh)}), {arch.opt}: meshless (loss, grad_norm, ms) "
        f"{want}, mesh {got}; {len(after)} DTensor leaves kept their "
        f"placements, each on its tensor's storage; DTensor's overhead at "
        f"world size 1: {got[1][2] - want[1][2]:+.1f} ms on the second step "
        f"({(got[1][2] / want[1][2] - 1) * 100:+.2f}%); peak "
        f"{peak:.1f} GB; {time.perf_counter() - t_ph:.1f} s")
    return {"meshless_ms": [w[2] for w in want],
            "mesh_ms": [g[2] for g in got]}


def mesh_families():
    """(c)'s LM families at narrow widths (MESH_D, MESH_LAYERS,
    MESH_VOCAB, fp32): name -> (LMConfig, optimizer, grouping)."""
    import dataclasses

    from repro_torch.configs.gemma_7b import CONFIG as GEMMA
    from repro_torch.configs.llama4_maverick import CONFIG as LLAMA4
    from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL
    from repro_torch.configs.qwen3_4b import CONFIG as QWEN
    from repro_torch.models.moe import MoEConfig
    narrow = dict(n_layers=MESH_LAYERS, d_model=MESH_D, n_heads=8,
                  head_dim=64, vocab=MESH_VOCAB, param_dtype="float32")
    rep = dataclasses.replace
    return {
        "gemma-like": (rep(GEMMA, **narrow, n_kv_heads=8, d_ff=2048),
                       "adamw", "strided"),
        "qwen3-like seq_shard_attn": (
            rep(QWEN, **narrow, n_kv_heads=2, d_ff=1536,
                seq_shard_attn=True), "adamw", "strided"),
        "mixtral-like irli_kchoice rows": (
            rep(MIXTRAL, **narrow, n_kv_heads=2, d_ff=1024, window=128,
                moe=MoEConfig(d_model=MESH_D, d_ff=1024, n_experts=8,
                              top_k=2, router="irli_kchoice",
                              ffn_chunk=MESH_ROWS_CHUNK)),
            "adamw", "plain"),
        "llama4-like EP adafactor": (
            rep(LLAMA4, **narrow, n_kv_heads=2, d_ff=512, chunk=128,
                moe=MoEConfig(d_model=MESH_D, d_ff=512, n_experts=16,
                              top_k=1, n_shared_experts=1)),
            "adafactor", "strided"),
    }


def kchoice_per_step(cfg) -> int:
    """The kchoice launches of one (c) train step of ``cfg``: one a MoE
    call (each sequence chunk of the per-row dispatch is one), in every
    layer's forward and, under remat, its recompute, for each of the
    MESH_MICRO microbatches; 0 without the k-choice router."""
    if cfg.moe is None or cfg.moe.router != "irli_kchoice":
        return 0
    b, seq = MESH_BATCH // MESH_MICRO, MESH_SEQ
    s_chunk = max(1, cfg.moe.ffn_chunk // b)
    rows = b * seq > cfg.moe.ffn_chunk and seq % s_chunk == 0 \
        and seq // s_chunk > 1
    return (cfg.n_layers * (2 if cfg.remat else 1)
            * (seq // s_chunk if rows else 1) * MESH_MICRO)


@contextlib.contextmanager
def keeping_grads(steps, sink: list):
    """Within the block, each ``steps.lm_grads`` call (the gradient a
    ``build_lm_train_step`` step computes, DTensors on a mesh) appends a
    copy of its gradient to ``sink``: the step's own gradient, read
    without a second forward and backward."""
    from repro_torch.models.module import flatten_with_paths
    lm_grads = steps.lm_grads

    def kept(*args, **kw):
        loss, grads = lm_grads(*args, **kw)
        sink.append({p: g.detach().clone()
                     for p, g in flatten_with_paths(grads)})
        return loss, grads

    steps.lm_grads = kept
    try:
        yield
    finally:
        steps.lm_grads = lm_grads


def mesh_rank_work(torch, dev, world: int, tmp: str) -> dict:
    """(c) on one of MESH_RANKS gloo ranks on the card, a (data 2, model 2)
    mesh: each family of ``mesh_families`` two steps meshless (this rank
    alone) and, from a copy of each step's meshless state placed on the
    mesh, the mesh step, the batches fed by ShardedLoader (a discrete
    router turns the two trajectories' last-bit differences into other
    routings, so each step starts from the same state); per step the
    losses and the largest relative error of any gradient leaf, the
    gradient each step computes (``lm_grads``, kept by ``keeping_grads``)
    on both sides; placements kept by each mesh step, the collective record of
    the second mesh step, and the kchoice launches of each step, counted
    from 0 just before it and read just after. Then compressed_psum
    (int8, top-k) over "data" on the gemma-like family's gradient tree,
    with noise drawn once: the sum, each payload of a rank in rank 0's
    data group (int8 codes and scales, top-k's kept ids and values) for
    the parent to recompute it, the error-feedback identity g + e_old =
    deq + e_new per leaf, and the payload's all-reduce bytes beside the
    fp32 tree's."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.collectives import CollectiveRecorder, profile
    from repro_torch.configs.lm_common import lm_rules
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps as S
    from repro_torch.models.module import (flatten_with_paths,
                                           map_with_paths, tensor_tree)
    from repro_torch.models.transformer import lm_init
    from repro_torch.optim.compression import (CompressionConfig,
                                               compress_grads,
                                               compressed_psum, ef_init)

    mesh = init_device_mesh(dev.type, (2, world // 2),
                            mesh_dim_names=("data", "model"))

    def copy(tree):
        return map_with_paths(lambda _, t: t.clone(), tree)

    def leaf_err(a, b) -> float:
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        return float((a - b).abs().max() / (a.abs().max() + 1e-30))

    out = {"families": {}}
    grads0 = None
    for name, (cfg, opt_kind, split) in mesh_families().items():
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        host = [{k: rng.integers(0, cfg.vocab, (MESH_BATCH, MESH_SEQ))
                 .astype(np.int32) for k in ("tokens", "labels")}
                for _ in range(2)]
        params = tensor_tree(lm_init(cfg, seed=SEED, device=dev))
        kw = dict(n_micro=MESH_MICRO, micro_split=split, lr=1e-3)
        plain, opt = S.build_lm_train_step(cfg, opt_kind, **kw)
        step, _ = S.build_lm_train_step(cfg, opt_kind, mesh=mesh, **kw)
        pspecs = lm_rules(cfg).specs(params)
        ospecs = S.opt_state_specs(opt_kind, params, pspecs, mesh)
        state = {"params": params, "opt": opt.init(params)}
        loader = ShardedLoader(iter(host), mesh,
                               lambda k: (("data",), None))
        row = {"loss": [], "mesh_loss": [], "grad_err": [], "plain_s": 0.0,
               "mesh_s": 0.0, "placements_kept": True, "kchoice": [],
               "kchoice_want": kchoice_per_step(cfg)}
        for i, b in enumerate(host):
            placed = S.place_train_state(copy(state), pspecs, ospecs, mesh)
            before = {p: tuple(t.placements)
                      for p, t in flatten_with_paths(placed)
                      if hasattr(t, "placements")}
            mb = next(loader)
            grads = []
            with keeping_grads(S, grads):
                t1 = time.perf_counter()
                state, m = plain(state, b)
                t2 = time.perf_counter()
                reset_launches()
                if i == 1:
                    with CollectiveRecorder() as rec:
                        placed, mm = step(placed, mb)
                    row["collectives"] = profile(rec.record)
                    row["collective_calls"] = len(rec.record)
                else:
                    placed, mm = step(placed, mb)
                row["kchoice"].append(LAUNCHES["kchoice"])
                row["plain_s"] += t2 - t1
                row["mesh_s"] += time.perf_counter() - t2
            g, mg = grads
            row["grad_err"].append(max(leaf_err(g[p], mg[p]) for p in g))
            if grads0 is None:
                grads0 = map_with_paths(lambda p, _: g[p], params)
            row["loss"].append(float(m["loss"]))
            row["mesh_loss"].append(float(mm["loss"]))
            row["placements_kept"] &= before == {
                p: tuple(t.placements) for p, t in flatten_with_paths(placed)
                if hasattr(t, "placements")}
            row["dtensors"] = len(before)
            del g, mg, placed
        if dev.type == "cuda":
            torch.cuda.synchronize()
        row["s"] = time.perf_counter() - t0
        out["families"][name] = row
        del state, params
    # compressed_psum over "data" on the gemma-like gradient tree
    t_c = time.perf_counter()
    comp = {}

    def nonzeros(t):
        flat = t.reshape(-1)
        ids = flat.nonzero().reshape(-1)
        return ids.cpu(), flat[ids].cpu()

    group = dist.get_process_group_ranks(mesh.get_group("data"))
    gen = torch.Generator(device=dev).manual_seed(SEED + mesh.get_rank())
    leaves = flatten_with_paths(grads0)
    fp32_bytes = sum(t.numel() * 4 for _, t in leaves)
    for kind in ("int8", "topk"):
        cfg = CompressionConfig(kind=kind, topk_frac=0.01)
        noise = [torch.rand(t.shape, generator=gen, device=dev) - 0.5
                 for _, t in leaves]
        ef = ef_init(grads0)
        payload, dec, new_ef = compress_grads(cfg, grads0, ef, noise)
        deq = dec(payload)
        ident = max(float((g + e - d - n).abs().max())
                    for (_, g), (_, e), (_, d), (_, n) in zip(
                        leaves, flatten_with_paths(ef),
                        flatten_with_paths(deq), flatten_with_paths(new_ef)))
        with CollectiveRecorder() as rec:
            summed, _ = compressed_psum(cfg, grads0, ef, noise, "data",
                                        mesh=mesh)
        c = {"ef_identity": ident, "payload": profile(rec.record),
             "calls": len(rec.record), "group": group}
        if 0 in group:      # rank 0's data group: its sum's inputs
            c["sent"] = [(q.cpu(), float(sc)) for q, sc in payload] \
                if kind == "int8" else [nonzeros(t) for t in payload]
        if mesh.get_rank() == 0:    # top-k's sum is sparse too
            c["summed"] = [t.cpu() if kind == "int8" else nonzeros(t)
                           for _, t in flatten_with_paths(summed)]
        comp[kind] = c
        del payload, deq, new_ef, summed
    comp["fp32_all_reduce_bytes"] = fp32_bytes
    comp["s"] = time.perf_counter() - t_c
    out["compression"] = comp
    return out


def check_compressed_psum(torch, kind: str, ranks: list) -> float:
    """Rank 0's compressed_psum of ``kind`` against the reference's
    formula over the payloads its data group sent: int8, the sum of the
    int32 codes times the mean scale; top-k, the sum of the kept values
    at their ids. Returns the largest error of a leaf relative to its
    largest |value|."""
    comp = [r["compression"][kind] for r in ranks]
    group = comp[0]["group"]
    err = 0.0
    for i, got in enumerate(comp[0]["summed"]):
        sent = [comp[r]["sent"][i] for r in group]
        if kind == "int8":
            codes = sum(q.to(torch.int32) for q, _ in sent)
            scale = torch.tensor(sum(sc for _, sc in sent),
                                 dtype=torch.float32) / len(sent)
            want = codes.to(torch.float32) * scale
        else:       # dense over the ids either side kept
            ids = torch.cat([got[0]] + [k for k, _ in sent]).unique()
            want = torch.zeros(int(ids.max()) + 1, dtype=torch.float32)
            for kept, vals in sent:
                want.index_add_(0, kept, vals)
            dense = torch.zeros_like(want)
            dense[got[0]] = got[1]
            want, got = want[ids], dense[ids]
        err = max(err, float((got - want).abs().max()
                             / (want.abs().max() + 1e-30)))
    return err


_GLOO_CUDA_LIB = []


def gloo_cuda_collectives(torch) -> None:
    """On the card, torch 2.11's functional all_gather_into_tensor (the
    gathers of DTensor's redistributions) ends the process (SIGSEGV) on
    CUDA tensors over gloo, on the world group and on a mesh's subgroup
    alike, while c10d's all_gather_into_tensor and all_to_all_single and
    the functional all_reduce and reduce_scatter work (probed on the card,
    PERF.md). For gloo ranks that share one card (NCCL refuses two ranks
    on one device), this registers a CUDA kernel for the functional
    all-gather and all-to-all that calls c10d's: the same collective,
    carried by the call gloo takes on CUDA tensors."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if _GLOO_CUDA_LIB:
        return

    def gather(x, group_size, group_name):
        out = x.new_empty((x.shape[0] * group_size, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    def all_to_all(x, output_split_sizes, input_split_sizes, group_name):
        out = x.new_empty((sum(output_split_sizes), *x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(output_split_sizes),
                               list(input_split_sizes),
                               group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", gather, "CUDA")
    lib.impl("all_to_all_single", all_to_all, "CUDA")
    _GLOO_CUDA_LIB.append(lib)


def wait_for(path: Path, seconds: float = 600.0) -> None:
    """Wait until ``path`` exists (a signal file another process writes);
    raise after ``seconds``."""
    end = time.monotonic() + seconds
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"no {path.name} signal in {seconds} s")
        time.sleep(0.05)


def mesh_rank(rank: int, world: int, tmp: str, dev_type: str) -> None:
    """One of the MESH_RANKS gloo ranks of (c) (spawned by
    registry_mesh_cell); writes its results to tmp/mesh<rank>.pt, or its
    traceback to tmp/err<rank>.txt."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    try:
        dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=300))
        # started while the parent runs (b); the card's context and a
        # first matmul once (b)'s peak is over (72-74 GB on an H100 80GB
        # HBM3 at 700 W), while (a) runs; the work at the parent's go
        wait_for(Path(tmp) / "card")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            gloo_cuda_collectives(torch)
            torch.ones((64, 64), device=dev).matmul(
                torch.ones((64, 64), device=dev)).sum().item()
        wait_for(Path(tmp) / "go")
        torch.save(mesh_rank_work(torch, dev, world, tmp),
                   Path(tmp) / f"mesh{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"err{rank}.txt").write_text(traceback.format_exc())
        raise


def check_mesh_ranks(torch, tmp: str) -> int:
    """(c)'s gates and log lines over the MESH_RANKS ranks' results in
    tmp (``mesh_rank_work``): per family the losses and gradient leaves
    within MESH_TOL, the placements kept on every rank and each mesh
    step's kchoice launches on every rank equal to ``kchoice_per_step``;
    compressed_psum's sums against the reference's formula
    (``check_compressed_psum``) and the error-feedback identity. Returns
    the mesh steps' kchoice launches over all ranks."""
    ranks = [torch.load(Path(tmp) / f"mesh{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    kchoice = 0
    for name, row in ranks[0]["families"].items():
        counts = [r["families"][name]["kchoice"] for r in ranks]
        if max(row["grad_err"]) > MESH_TOL or any(
                abs(a - b) > MESH_TOL * abs(a)
                for a, b in zip(row["loss"], row["mesh_loss"])) \
                or not all(r["families"][name]["placements_kept"]
                           for r in ranks) \
                or any(n != row["kchoice_want"] for c in counts for n in c):
            raise AssertionError(f"(c) {name}: kchoice by rank and step "
                                 f"{counts}; {row}")
        kchoice += sum(map(sum, counts))
        log(f"mesh (c) {name} on {MESH_RANKS} gloo ranks (data 2, model 2), "
            f"[{MESH_BATCH}, {MESH_SEQ}] by ShardedLoader, n_micro "
            f"{MESH_MICRO}: losses meshless "
            f"{row['loss']} mesh {row['mesh_loss']}, largest gradient leaf "
            f"error {max(row['grad_err']):.2e} (of its max |g|), each step "
            f"from the meshless state; {row['dtensors']} DTensor leaves kept "
            f"their placements, "
            f"kchoice launches {row['kchoice']} by mesh step on rank 0 "
            f"({row['kchoice_want']} a step wanted); one step's "
            f"collectives on rank 0 ({row['collective_calls']} calls) by "
            f"kind, bytes: {row['collectives']}; the two steps "
            f"{row['plain_s']:.2f} s meshless, {row['mesh_s']:.2f} s on the "
            f"mesh (4 ranks time-share the card); {row['s']:.1f} s")
    comp = ranks[0]["compression"]
    t_check = time.perf_counter()
    for kind in ("int8", "topk"):
        c = comp[kind]
        err = check_compressed_psum(torch, kind, ranks)
        if c["ef_identity"] > 1e-6 or err > 1e-6:
            raise AssertionError(f"(c) compressed_psum {kind}: the sum's "
                                 f"error {err}, the identity's "
                                 f"{c['ef_identity']}")
        log(f"mesh (c) compressed_psum {kind} over \"data\" on the "
            f"gemma-like gradient tree: rank 0's sum against the "
            f"reference's formula over ranks {c['group']}' payloads to "
            f"{err:.1e} of each leaf's max; g + e_old = deq + e_new to "
            f"{c['ef_identity']:.1e}; the payload's collectives on rank 0 "
            f"({c['calls']} calls) by kind, bytes: {c['payload']} against "
            f"{comp['fp32_all_reduce_bytes']:,} bytes of the fp32 tree's "
            f"all-reduce")
    log(f"mesh (c) compressed_psum: {comp['s']:.1f} s on rank 0, its "
        f"check here {time.perf_counter() - t_check:.1f} s")
    if kchoice < 1:
        raise AssertionError("(c) the k-choice router launched no kchoice")
    return kchoice


def registry_mesh_cell(torch, dev, smi: str) -> dict:
    """Phase 18, the registry and the LM on a mesh: (b) mesh_train_phase
    and (a) registry_phase, in this order, on a world-size-1 NCCL
    DeviceMesh in this process; (c) MESH_RANKS gloo ranks on the card
    (mesh_rank): every LM family's train step on a (data 2, model 2) mesh
    held to the meshless step (loss and every gradient leaf within
    MESH_TOL), placements kept, exact kchoice launches, the collective
    record of a step, and compressed_psum's sum against the reference's
    formula, its error-feedback identity and payload bytes
    (``check_mesh_ranks``)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t_cell = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="irli_mesh_")
    # (c)'s ranks start first and set up (imports, gloo) while (b) runs
    # here, take the card (tmp/card) while (a) runs, and work at tmp/go
    procs = start_ranks(mesh_rank, MESH_RANKS, tmp, dev.type)
    try:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(tmp) / "solo_store"), 1), rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            train = mesh_train_phase(torch, dev, mesh)
            (Path(tmp) / "card").touch()
            reg = registry_phase(torch, dev, mesh)
        finally:
            dist.destroy_process_group()
    except BaseException:
        for p in procs:
            p.kill()
            p.join()
        raise
    t0 = time.perf_counter()
    (Path(tmp) / "go").touch()
    join_ranks(procs, tmp, timeout=240.0)
    kchoice = check_mesh_ranks(torch, tmp)
    log(f"mesh (c): {time.perf_counter() - t0:.1f} s from the go (the "
        f"ranks set up during (b) and (a)); {smi}")
    log(f"registry and mesh cell: {time.perf_counter() - t_cell:.1f} s")
    return {"launches": {"registry": reg["launches"],
                         "mesh": {"kchoice": kchoice}},
            "train": train}


# ------------------------------------------------------- 19. the dry run --
# launch/dryrun.py on the card's machine: (a) irli-deep1b serve_query on
# the fake 256-rank production mesh, its record printed and its store
# accounting checked; then the dry run's prediction of one call at world
# size 1, held against the same call on the card under the same recorder
# (analysis/cost.CostRecorder): (a') build_irli_serve over the search
# cell's index, int8 store and queries, (b) the model-train cell's gemma-7b
# step. Launches and argument bytes equal, FLOPs within DRY_FLOPS_TOL, the
# predicted peak within DRY_PEAK_TOL of torch.cuda.max_memory_allocated().
# (c) four CTR and SchNet cells on the same fake 256-rank mesh, with fake
# cuda tensors: each record printed and equal to DRY_CPU_RECORDS, the same
# cells' records on the CPU (argument bytes, FLOPs, launches,
# collectives). (d) on a one-rank NCCL mesh, the arguments placed as
# DTensors (the path the cells take), the dry run's prediction of four
# calls held as (a') holds its one (DRY_CALLS: DIEN serve_p99 and
# dlrm-mlperf retrieval_cand at full width, dlrm-mlperf train_batch at B =
# 65,536 with its tables cut to DLRM_TABLE_CAP rows, as the model-train
# cell cuts them, SchNet minibatch_lg at its cell's shapes), and each
# call's output held to the meshless call on the same inputs: prob and
# scores to TOL, ids equal, the train step's loss to TOL and its params
# to TOL (but where the meshless step's first moment is under
# SIGN_FLOOR of its leaf's largest, whose update's sign rounding may
# flip: there within 2·lr). (e) four LM serve cells (DRY_LM_CELLS) on the
# same fake 256-rank mesh, with fake cuda tensors: each cell's mesh step
# recorded (the meshless trace of its replication is left to the CPU),
# printed and equal to DRY_CPU_RECORDS in DRY_KEYS, as (c) holds its
# cells. (f) on a one-rank NCCL mesh, the arguments placed as DTensors by
# the cells' specs, the dry run's prediction of four LM serve calls held
# as (d) holds its four (DRY_LM_CALLS: gemma-7b's prefill at 4 of 28
# layers, whose mesh attention launches flash_attention once a layer;
# gemma-7b's decode (its caches' kv heads over "model"); yi-6b's decode
# (the caches' sequence over "model": the log-sum-exp merge); mixtral's
# decode at 2 of 32 layers (the SWA ring wrapping, the MoE)), and each
# mesh call's output held to the meshless call on the same inputs: next
# tokens equal, logits (and the prefill's hidden state) within
# DECODE_TOL relative L2 (the prefill's within PREFILL_TOL), each cache
# after the step within DECODE_TOL of the meshless step's. (a)-(d) have
# DRY_MS_MAX, (e) and (f) DRY_LM_MS_MAX.
DRY_FLOPS_TOL, DRY_PEAK_TOL = 1e-3, 0.10
DRY_MS_MAX = 45_000                         # (a)-(d)'s budget
DRY_LM_MS_MAX = 60_000                      # (e) and (f)'s budget
#: (c)'s CTR and SchNet cells and (e)'s LM serve cells
DRY_CTR_CELLS = ("dlrm-mlperf/train_batch", "dien/serve_p99",
                 "dlrm-mlperf/retrieval_cand", "schnet/ogb_products")
DRY_LM_CELLS = ("gemma-7b/decode_32k", "yi-6b/decode_32k",
                "gemma-7b/prefill_32k", "mixtral-8x7b/long_500k")
#: (f)'s calls: label, arch, layers kept (a cut of depth), kind, batch
#: rows, the prompt's length or the decode's context, the decode rows'
#: first position (row i at pos0 + 3·i; mixtral's 4,096-slot ring wraps)
DRY_LM_CALLS = (
    ("gemma-7b prefill (4 of 28 layers, [1, 32768])", "gemma-7b", 4,
     "prefill", 1, 32768, 0),
    ("gemma-7b decode (4 of 28 layers, B = 8, context 4096)", "gemma-7b",
     4, "decode", 8, 4096, 4000),
    ("yi-6b decode (4 of 32 layers, B = 8, context 4096)", "yi-6b", 4,
     "decode", 8, 4096, 4000),
    ("mixtral-8x7b decode (2 of 32 layers, B = 8, context 4096)",
     "mixtral-8x7b", 2, "decode", 8, 4096, 4090),
)
SIGN_FLOOR = 1e-3
DRY_DLRM_BATCH = 65_536                     # (d)'s train_batch, the cell's
#: the records of (c)'s and (e)'s cells on the fake 256-rank mesh (data
#: 16 x model 16) by ``python -m repro_torch.launch.dryrun --mesh single``
#: on the CPU (torch 2.13, meta tensors standing for the card's): the card
#: machine's must equal them in these keys
DRY_KEYS = ("argument_bytes", "flops", "launches", "collective_count",
            "collectives")
DRY_CPU_RECORDS = {
    "dlrm-mlperf/train_batch": {
        "argument_bytes": 1236425936, "flops": 60365471744, "launches": {},
        "collective_count": 38, "collectives": {
            "all-gather": 888706560, "all-reduce": 64001552,
            "reduce-scatter": 54525952, "all-to-all": 0,
            "collective-permute": 0}},
    "dien/serve_p99": {
        "argument_bytes": 8271816, "flops": 844523520,
        "launches": {"embedding_bag": 2}, "collective_count": 6,
        "collectives": {"all-gather": 206848, "all-reduce": 232704,
                        "reduce-scatter": 232704, "all-to-all": 0,
                        "collective-permute": 0}},
    "dlrm-mlperf/retrieval_cand": {
        "argument_bytes": 2097664, "flops": 1048576,
        "launches": {"distance_topk": 1}, "collective_count": 2,
        "collectives": {"all-gather": 217600, "all-reduce": 0,
                        "reduce-scatter": 0, "all-to-all": 0,
                        "collective-permute": 0}},
    "schnet/ogb_products": {
        "argument_bytes": 7333336, "flops": 76061931520, "launches": {},
        "collective_count": 126, "collectives": {
            "all-gather": 3997904128, "all-reduce": 940936,
            "reduce-scatter": 249839616, "all-to-all": 0,
            "collective-permute": 0}},
    "gemma-7b/decode_32k": {
        "argument_bytes": 8583731264, "flops": 16053698560, "launches": {},
        "collective_count": 58, "collectives": {
            "all-gather": 0, "all-reduce": 2801728, "reduce-scatter": 0,
            "all-to-all": 0, "collective-permute": 0}},
    "yi-6b/decode_32k": {
        "argument_bytes": 1831870528, "flops": 14388559872, "launches": {},
        "collective_count": 258, "collectives": {
            "all-gather": 2621440, "all-reduce": 8519744,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}},
    "gemma-7b/prefill_32k": {
        "argument_bytes": 1067800576, "flops": 94284258213888,
        "launches": {"flash_attention": 28}, "collective_count": 58,
        "collectives": {"all-gather": 0, "all-reduce": 22951231504,
                        "reduce-scatter": 0, "all-to-all": 0,
                        "collective-permute": 0}},
    "mixtral-8x7b/long_500k": {
        "argument_bytes": 5842411528, "flops": 45291798528, "launches": {},
        "collective_count": 386, "collectives": {
            "all-gather": 4587520, "all-reduce": 18112520,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}},
}


def dry_peak_call(torch, fn, args) -> tuple:
    """fn(*args) once on the card under the cost recorder -> (record,
    result, measured peak bytes): torch.cuda.max_memory_allocated() over
    the call, after reset_peak_memory_stats() with the arguments resident,
    less what was resident besides them."""
    from repro_torch.analysis.cost import CostRecorder, local_bytes
    arg_bytes = local_bytes(args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = CostRecorder(device="cuda")
    rec.hold_arguments(args)
    with rec:
        out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base + arg_bytes
    return rec.record(arg_bytes, local_bytes(out)), out, peak


def hold_prediction(label: str, pred: dict, real: dict, peak: int) -> dict:
    """The dry run's record ``pred`` against the card's ``real`` (and its
    measured ``peak``): each gate's two numbers logged, raise on a miss."""
    flops_rel = abs(pred["flops"] - real["flops"]) / max(real["flops"], 1)
    peak_rel = abs(pred["peak_bytes"] - peak) / max(peak, 1)
    log(f"dry run (19) {label}: launches predicted {pred['launches']}, on "
        f"the card {real['launches']}; argument bytes {pred['argument_bytes']}"
        f", {real['argument_bytes']}; FLOPs {pred['flops']}, {real['flops']}"
        f" (rel {flops_rel:.2e}); peak bytes {pred['peak_bytes']}, "
        f"max_memory_allocated {peak} (rel {peak_rel:.4f}; the recorder's "
        f"tally on the card {real['peak_bytes']}); HBM bytes "
        f"{pred['hbm_bytes']}, {real['hbm_bytes']}; host reads "
        f"{pred['host_reads']}, {real['host_reads']}; collectives "
        f"{pred['collective_count']}, {real['collective_count']}; trace "
        f"{pred['trace_s']} s")
    if pred["launches"] != real["launches"]:
        raise AssertionError(f"dry run {label}: launches {pred['launches']}"
                             f" predicted, {real['launches']} on the card")
    if pred["argument_bytes"] != real["argument_bytes"]:
        raise AssertionError(f"dry run {label}: argument bytes "
                             f"{pred['argument_bytes']} predicted, "
                             f"{real['argument_bytes']} on the card")
    if flops_rel > DRY_FLOPS_TOL:
        raise AssertionError(f"dry run {label}: FLOPs {pred['flops']} "
                             f"predicted, {real['flops']} on the card")
    if peak_rel > DRY_PEAK_TOL:
        raise AssertionError(f"dry run {label}: peak {pred['peak_bytes']} "
                             f"predicted, {peak} measured")
    return {"predicted": pred, "card": real, "measured_peak": peak,
            "flops_rel": flops_rel, "peak_rel": peak_rel}


def dryrun_train(torch, label: str, step, state, batch) -> dict:
    """(b) one train step's dry run (its arguments' fakes,
    dryrun.fake_like) against the same step on the card."""
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    pred = DR.dry_record(step, lambda: DR.fake_like((state, batch)))
    real, _, peak = dry_peak_call(torch, step, (state, batch))
    out = hold_prediction(label, pred, real, peak)
    out["ms"] = (time.perf_counter() - t0) * 1e3
    log(f"dry run (19) {label}: {out['ms'] / 1e3:.1f} s")
    return out


def dryrun_cpu_cells(mesh) -> dict:
    """(c) DRY_CTR_CELLS on the fake 256-rank ``mesh`` (inside its fake
    world): each record logged and held to the CPU's."""
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    out = {}
    for key in DRY_CTR_CELLS:
        want = DRY_CPU_RECORDS[key]
        rec = DR.run_cell(*key.split("/"), mesh)
        log(f"dry run (19c) {key} on the fake 256-rank mesh: "
            f"{json.dumps(rec)}")
        got = {k: rec[k] for k in DRY_KEYS}
        if got != want:
            raise AssertionError(f"dry run (19c) {key}: {got} on the card's "
                                 f"machine, {want} on the CPU")
        out[key] = rec
    out["ms"] = (time.perf_counter() - t0) * 1e3
    log(f"dry run (19c): {out['ms'] / 1e3:.1f} s, each record equal to the "
        f"CPU's in {', '.join(DRY_KEYS)}")
    return out


def dryrun_lm_cells(mesh) -> dict:
    """(e) DRY_LM_CELLS on the fake 256-rank ``mesh`` (inside its fake
    world): each cell's mesh step recorded on rank 0's fake DTensors
    (``lower_cell`` + ``dry_record``), its argument bytes held to the
    specs', the record logged and held to the CPU's in DRY_KEYS."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    out = {}
    for key in DRY_LM_CELLS:
        arch, shape = key.split("/")
        step, make_args, box = DR.lower_cell(get_arch(arch), shape, mesh)
        rec = DR.dry_record(step, make_args)
        log(f"dry run (19e) {key} on the fake 256-rank mesh: "
            f"{json.dumps(rec)}")
        if rec["argument_bytes"] != box["want"]:
            raise AssertionError(f"dry run (19e) {key}: argument bytes "
                                 f"{rec['argument_bytes']}, {box['want']} "
                                 f"by the specs")
        got = {k: rec[k] for k in DRY_KEYS}
        if got != DRY_CPU_RECORDS[key]:
            raise AssertionError(f"dry run (19e) {key}: {got} on the card's "
                                 f"machine, {DRY_CPU_RECORDS[key]} on the "
                                 f"CPU")
        out[key] = rec
    out["ms"] = (time.perf_counter() - t0) * 1e3
    log(f"dry run (19e): {out['ms'] / 1e3:.1f} s, each record equal to the "
        f"CPU's in {', '.join(DRY_KEYS)}")
    return out


def dryrun_cell(torch, dev, idx, store8, queries) -> dict:
    """19. (a) the production cell's dry run, (c) and (e) DRY_CPU_RECORDS's
    cells on the same mesh, and (a') the world-size-1 serve call's (see
    the section's comment). Needs no default process group on entry and
    leaves none."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh)
    from repro_torch.launch.steps import build_irli_serve

    if dist.is_initialized():
        raise AssertionError("dry run (19): a default process group is "
                             "already up")
    t0 = time.perf_counter()
    out = {}
    DR.fake_world(256)
    try:
        mesh = make_production_mesh(device_type="cuda")
        rec = DR.run_cell("irli-deep1b", "serve_query", mesh)
        log(f"dry run (19a) irli-deep1b/serve_query on the fake 256-rank "
            f"mesh: {json.dumps(rec)}")
        out["serve_query"] = rec
        out["cells"] = dryrun_cpu_cells(mesh)
        out["lm_cells"] = dryrun_lm_cells(mesh)

        DR.fake_world(1)

        def step_of():
            return build_irli_serve(make_host_mesh(1, device_type="cuda"),
                                    M, TAU, K, store_dtype="int8",
                                    store_block=BLOCK)

        params = {"scorer": idx.params, "members": idx.index.members,
                  "base_codes": store8.codes, "base_scales": store8.scales}
        batch = {"queries": queries}
        pred = DR.dry_record(step_of(), lambda: DR.fake_like((params,
                                                              batch)))
    finally:
        dist.destroy_process_group()
    tmp = tempfile.mkdtemp(prefix="irli_dry_")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(Path(tmp) / "solo_store"), 1), rank=0, world_size=1)
    try:
        step_of()(params, batch)                        # warm-up, a step of
        torch.cuda.synchronize()                        # its own
        real, _, peak = dry_peak_call(torch, step_of(), (params, batch))
    finally:
        dist.destroy_process_group()
    out["serve_world1"] = hold_prediction(
        f"build_irli_serve at world size 1 (Q={queries.shape[0]}, m={M}, "
        f"tau={TAU}, k={K}, int8 store of {store8.codes.shape[0]} rows)",
        pred, real, peak)
    out["ms"] = (time.perf_counter() - t0) * 1e3 - out["lm_cells"]["ms"]
    log(f"dry run (19a): {out['ms'] / 1e3:.1f} s ((e) not included)")
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _whole(t):
    """A DTensor's whole tensor, a plain tensor as it is (a copy neither:
    compare before the next call writes)."""
    from repro_torch.models.module import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _close(label: str, got, want) -> float:
    """|got - want| <= TOL + TOL·|want| everywhere, or raise -> the
    largest |got - want|."""
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    ok = bool(((got.float() - want.float()).abs()
               <= TOL + TOL * want.float().abs()).all())
    if not ok:
        raise AssertionError(f"dry run (19d) {label}: the mesh call differs "
                             f"from the meshless one by {err}")
    return err


def dry_call_cases(torch, dev) -> list:
    """(d)'s four calls (DRY_CALLS in the section's comment), each a dict:
    label, the step, its whole arguments on the card, ``place(args,
    mesh)`` (its DTensors on a mesh by the cell's specs), the kind
    (serve or train) and, for a serve call, ``hold(mesh_out, plain_out)``
    -> the largest difference."""
    import dataclasses

    from repro_torch.configs import dien as DIEN
    from repro_torch.configs import dlrm_mlperf as DLRM
    from repro_torch.configs import schnet as SCH
    from repro_torch.configs.recsys_common import RETRIEVAL_K
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import behavior_stream, criteo_stream
    from repro_torch.launch import steps as S
    from repro_torch.models import recsys as RS
    from repro_torch.models.gnn import schnet_init
    from repro_torch.models.module import place_tree, tensor_tree

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)

    def on(host):
        return {k: torch.as_tensor(v, device=dev) for k, v in host.items()}

    def placer(arch, rules, in_specs, train):
        def place(args, mesh):
            head, batch = args
            bs = in_specs(mesh)
            if not train:
                return (place_tree(head, rules.specs(head), mesh),
                        place_tree(batch, bs, mesh))
            ps = rules.specs(head["params"])
            os_ = S.opt_state_specs(arch.opt, head["params"], ps, mesh)
            return (S.place_train_state(head, ps, os_, mesh),
                    place_tree(batch, bs, mesh))
        return place

    cases = []
    # DIEN serve_p99 at configs/dien.CONFIG's full width
    arch = get_arch("dien")
    cell = arch.cells["serve_p99"]
    params = tensor_tree(RS.dien_init(DIEN.CONFIG, seed=SEED, device=dev))
    batch = on(next(behavior_stream(512, DIEN.CONFIG.seq_len,
                                    DIEN.CONFIG.item_vocab,
                                    DIEN.CONFIG.cate_vocab, seed=SEED)))
    cases.append({
        "label": f"dien serve_p99 (item table {DIEN.CONFIG.item_vocab} x "
                 f"{DIEN.CONFIG.embed_dim}, B = 512)",
        "step": cell.step(), "whole": (params, batch), "kind": "serve",
        "launches": {"embedding_bag": 2},
        "place": placer(arch, arch.rules(), cell.in_specs, False),
        "hold": lambda a, b: _close("dien prob", _whole(a["prob"]),
                                    b["prob"])})
    # dlrm-mlperf retrieval_cand at full width
    arch = get_arch("dlrm-mlperf")
    cell = arch.cells["retrieval_cand"]
    tshape = tuple(cell.params(None)["item_table"]["table"].shape)
    qshape = tuple(cell.inputs(None)["query"].shape)
    params = {"item_table": {"table": torch.randn(tshape, generator=gen,
                                                  device=dev)}}
    batch = {"query": torch.randn(qshape, generator=gen, device=dev)}

    def hold_retrieval(a, b):
        if not torch.equal(a["ids"], b["ids"]):
            raise AssertionError("dry run (19d) retrieval: the mesh call's "
                                 "ids differ from the meshless call's")
        return _close("retrieval scores", a["scores"], b["scores"])

    cases.append({
        "label": f"dlrm-mlperf retrieval_cand (item table {tshape[0]} x "
                 f"{tshape[1]}, k = {RETRIEVAL_K})",
        "step": cell.step(), "whole": (params, batch), "kind": "serve",
        "launches": {"distance_topk": 1},
        "place": placer(arch, arch.rules(), cell.in_specs, False),
        "hold": hold_retrieval})
    # dlrm-mlperf train_batch at B = 65,536, the tables cut as the
    # model-train cell cuts them
    vocab = tuple(min(v, DLRM_TABLE_CAP) for v in RS.DLRMConfig().vocab_sizes)
    pad = (-sum(vocab)) % 512
    cfg = dataclasses.replace(RS.DLRMConfig(),
                              vocab_sizes=vocab[:-1] + (vocab[-1] + pad,))
    params, offsets = RS.dlrm_init(cfg, seed=SEED, device=dev)
    batch = on(next(criteo_stream(DRY_DLRM_BATCH, cfg.n_dense, vocab,
                                  seed=SEED)))
    step, opt = S.build_ctr_train_step(lambda p, b: RS.dlrm_apply(
        p, cfg, offsets.to(b["sparse"].device), b["dense"], b["sparse"]),
        arch.opt, lr=TRAIN_LR)
    cell = arch.cells["train_batch"]
    log(f"dry run (19d) dlrm-mlperf train_batch: cut to one card, each "
        f"40M-row table to {DLRM_TABLE_CAP} rows ({sum(cfg.vocab_sizes)} "
        f"rows of {DLRM.TOTAL_ROWS}), the batch {DRY_DLRM_BATCH} as the "
        f"cell's")
    cases.append({
        "label": f"dlrm-mlperf train_batch (B = {DRY_DLRM_BATCH}, tables "
                 f"cut to {sum(cfg.vocab_sizes)} rows)",
        "step": step, "whole": ({"params": params,
                                 "opt": opt.init(params)}, batch),
        "kind": "train", "launches": {},
        "place": placer(arch, arch.rules(), cell.in_specs, True)})
    # SchNet minibatch_lg at its cell's shapes
    arch = get_arch("schnet")
    cell = arch.cells["minibatch_lg"]
    sh = SCH.CELL_SHAPES["minibatch_lg"]
    N, E, c = sh["pad_nodes"], sh["pad_edges"], sh["cfg"]
    params = schnet_init(c, seed=SEED, device=dev)
    batch = {"feats": torch.randn((N, c.d_in), generator=gen, device=dev),
             "src": torch.randint(0, N, (E,), generator=gen, device=dev,
                                  dtype=torch.int32),
             "dst": torch.randint(0, N, (E,), generator=gen, device=dev,
                                  dtype=torch.int32),
             "dist": torch.rand((E,), generator=gen, device=dev) * 12,
             "labels": torch.randint(0, c.n_out, (N,), generator=gen,
                                     device=dev, dtype=torch.int32),
             "node_mask": (torch.rand((N,), generator=gen, device=dev)
                           < 0.9).float()}
    step, opt = S.build_gnn_node_train(c, arch.opt, lr=TRAIN_LR)
    cases.append({
        "label": f"schnet minibatch_lg ({N} nodes, {E} edges)",
        "step": step, "whole": ({"params": params,
                                 "opt": opt.init(params)}, batch),
        "kind": "train", "launches": {},
        "place": placer(arch, arch.rules(), cell.in_specs, True)})
    return cases


def hold_train_call(torch, label: str, step, whole, placed) -> dict:
    """(d) a train call: one warm mesh step (in place, the whole state
    with it: one rank's DTensors hold its storage), the meshless step from
    a copy of the warmed state, then the measured mesh step -> (record,
    measured peak, the largest loss and params differences), the loss to
    TOL and each param to TOL but where the meshless first moment is
    under SIGN_FLOOR of its leaf's largest (within 2·lr there)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.module import flatten_with_paths
    step(*placed)
    torch.cuda.synchronize()
    copy = (_tree_map(lambda t: t.clone(), whole[0]), whole[1])
    ref_state, ref_metrics = step(*copy)
    ref = {p: t for p, t in flatten_with_paths(ref_state["params"])}
    # where an update's sign may flip: the first moment under SIGN_FLOOR
    free = {p: t.abs() <= SIGN_FLOOR * float(t.abs().max())
            for p, t in flatten_with_paths(ref_state["opt"]["m"])}
    del copy, ref_state
    torch.cuda.empty_cache()
    reset_launches()
    real, (state, metrics), peak = dry_peak_call(torch, step, placed)
    launches = {n: c for n, c in LAUNCHES.items() if c}
    loss_err = _close(f"{label} loss", _whole(metrics["loss"]),
                      ref_metrics["loss"])
    worst, loose = 0.0, 0
    for path, t in flatten_with_paths(state["params"]):
        got, want, f = _whole(t).float(), ref[path].float(), free[path]
        diff = (got - want).abs()
        past = diff > TOL + TOL * want.abs()
        if bool((past & ~f).any() or (diff > 2 * TRAIN_LR + TOL).any()):
            raise AssertionError(f"dry run (19d) {label}: param {path} "
                                 f"differs from the meshless step's by "
                                 f"{float(diff.max())}")
        worst = max(worst, float(diff[~f].max()) if bool((~f).any())
                    else 0.0)
        loose += int((past & f).sum())
    log(f"dry run (19d) {label}: mesh step = meshless step: loss "
        f"{float(metrics['loss'])} (|diff| {loss_err:.3g}), params within "
        f"{worst:.3g} ({loose} elements with a first moment under "
        f"SIGN_FLOOR of their leaf's largest past TOL, within 2·lr)")
    return {"record": real, "peak": peak, "loss_err": loss_err,
            "params_err": worst, "sign_exempt": loose, "launches": launches}


def dryrun_mesh_calls(torch, dev) -> dict:
    """19. (d) (see the section's comment). Needs no default process group
    on entry and leaves none."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.module import flatten_with_paths, is_dtensor
    if dist.is_initialized():
        raise AssertionError("dry run (19d): a default process group is "
                             "already up")
    t0 = time.perf_counter()
    log(f"dry run (19d): {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated on entry")
    cases = dry_call_cases(torch, dev)
    torch.cuda.synchronize()
    t_built = time.perf_counter()
    preds = {}
    DR.fake_world(1)
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        for c in cases:
            preds[c["label"]] = DR.dry_record(
                c["step"], lambda c=c: c["place"](DR.fake_like(c["whole"]),
                                                  mesh))
    finally:
        dist.destroy_process_group()
    t_pred = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ctr_dry_")
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=dist.FileStore(
            str(Path(tmp) / "solo_store"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = make_host_mesh(1, device_type=dev.type)
        for c in cases:
            label, step = c["label"], c["step"]
            placed = c["place"](c["whole"], mesh)
            if c["kind"] == "train":
                res = hold_train_call(torch, label, step, c["whole"], placed)
                real, peak = res.pop("record"), res.pop("peak")
            else:
                step(*placed)                             # warm-up
                torch.cuda.synchronize()
                reset_launches()
                real, got, peak = dry_peak_call(torch, step, placed)
                launches = {n: k for n, k in LAUNCHES.items() if k}
                err = c["hold"](got, step(*c["whole"]))
                if not all(is_dtensor(t) for _, t in
                           flatten_with_paths(dict(enumerate(placed)))):
                    raise AssertionError(f"dry run (19d) {label}: an "
                                         f"argument is not a DTensor")
                log(f"dry run (19d) {label}: mesh call = meshless call "
                    f"(largest difference {err:.3g})")
                res = {"err": err, "launches": launches}
            if res["launches"] != c["launches"] or \
                    preds[label]["launches"] != c["launches"]:
                raise AssertionError(
                    f"dry run (19d) {label}: {res['launches']} launched, "
                    f"{preds[label]['launches']} predicted, "
                    f"{c['launches']} wanted")
            res.update(hold_prediction(
                f"(19d) {label} on a one-rank NCCL mesh",
                preds[label], real, peak))
            out[label] = res
            del placed
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del cases
    torch.cuda.empty_cache()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    log(f"dry run (19d): {out['ms'] / 1e3:.1f} s (inputs built "
        f"{t_built - t0:.1f} s, predictions {t_pred - t_built:.1f} s)")
    return out


def _tree_leaves(tree) -> list:
    """The tensors of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def dry_lm_cases(torch, dev) -> list:
    """(f)'s calls (DRY_LM_CALLS), each a dict: label, the step, its whole
    arguments on the card (random weights from ``lm_init``, cut in
    depth; tokens, or a decode's token, positions and caches filled with
    N(0, 1) bf16 values), ``place(args, mesh)`` (its DTensors by the
    arch's rules and the cell's specs), the launches wanted, the kind."""
    import dataclasses
    import importlib

    from repro_torch.configs.lm_common import _cache_sharding, lm_rules
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import steps as S
    from repro_torch.models.module import data_axes, place_tree, tensor_tree
    from repro_torch.models.transformer import init_cache, lm_init

    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    models, cases = {}, []
    for label, name, layers, kind, B, n, pos0 in DRY_LM_CALLS:
        if (name, layers) not in models:
            cfg = dataclasses.replace(
                importlib.import_module(ARCHS[name]).CONFIG, n_layers=layers)
            models[name, layers] = (cfg, tensor_tree(lm_init(
                cfg, seed=SEED, device=dev)))
        cfg, params = models[name, layers]
        log(f"dry run (19f) {label}: {name} cut to {layers} of its layers "
            f"(depth only; every width the config's)")
        if kind == "prefill":
            batch = {"tokens": torch.randint(0, cfg.vocab, (B, n),
                                             generator=gen, device=dev,
                                             dtype=torch.int32)}
            step = S.build_lm_prefill(cfg)
            launches = {"flash_attention": layers}

            def specs(mesh, cfg=cfg):
                return {"tokens": (data_axes(mesh), None)}
        else:
            caches = init_cache(cfg, B, n, device=dev)
            for c in caches:
                for t in c.values():
                    t.normal_(generator=gen)
            batch = {"token": torch.randint(0, cfg.vocab, (B,),
                                            generator=gen, device=dev,
                                            dtype=torch.int32),
                     "pos": pos0 + 3 * torch.arange(B, device=dev,
                                                    dtype=torch.int32),
                     "caches": caches}
            step = S.build_lm_decode(cfg, n)
            launches = {}

            def specs(mesh, cfg=cfg):
                dp = data_axes(mesh)
                return {"token": (dp,), "pos": (dp,),
                        "caches": _cache_sharding(cfg, mesh)}

        def place(args, mesh, cfg=cfg, specs=specs):
            head, b = args
            return (place_tree(head, lm_rules(cfg).specs(head), mesh),
                    place_tree(b, specs(mesh), mesh))

        cases.append({"label": label, "step": step, "kind": kind,
                      "whole": (params, batch), "place": place,
                      "launches": launches})
    return cases


def hold_lm_call(label: str, kind: str, got: dict, want: dict) -> dict:
    """(f) a mesh call's outputs against the meshless call's: next tokens
    equal, logits (and a prefill's hidden state) within DECODE_TOL
    relative L2 (a prefill's within PREFILL_TOL), a decode's caches after
    the step each within DECODE_TOL -> the largest distances."""
    tol = PREFILL_TOL if kind == "prefill" else DECODE_TOL
    tok = _whole(got["next_token"])
    if not bool((tok == want["next_token"]).all()):
        raise AssertionError(f"dry run (19f) {label}: next tokens "
                             f"{tok.tolist()} on the mesh, "
                             f"{want['next_token'].tolist()} meshless")
    errs = {"logits": rel_l2(_whole(got["logits"]), want["logits"]),
            "hidden": rel_l2(_whole(got["hidden"]), want["hidden"])}
    if kind == "decode":
        errs["caches"] = max(
            rel_l2(_whole(a[n]), b[n])
            for a, b in zip(got["caches"], want["caches"])
            for n in ("k", "v"))
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"dry run (19f) {label}: the mesh call differs "
                             f"from the meshless one by {bad} (relative L2,"
                             f" limit {tol})")
    log(f"dry run (19f) {label}: mesh call = meshless call (next tokens "
        f"equal; relative L2 {', '.join(f'{k} {e:.3e}' for k, e in errs.items())}"
        f", limit {tol})")
    return errs


def dryrun_lm_calls(torch, dev) -> dict:
    """19. (f) (see the section's comment). Needs no default process group
    on entry and leaves none."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.module import is_dtensor
    if dist.is_initialized():
        raise AssertionError("dry run (19f): a default process group is "
                             "already up")
    t0 = time.perf_counter()
    cases = dry_lm_cases(torch, dev)
    torch.cuda.synchronize()
    t_built = time.perf_counter()
    preds = {}
    DR.fake_world(1)
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        for c in cases:
            preds[c["label"]] = DR.dry_record(
                c["step"], lambda c=c: c["place"](DR.fake_like(c["whole"]),
                                                  mesh))
    finally:
        dist.destroy_process_group()
    t_pred = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="lm_dry_")
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", store=dist.FileStore(
            str(Path(tmp) / "solo_store"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = make_host_mesh(1, device_type=dev.type)
        for c in cases:
            label, step = c["label"], c["step"]
            params, batch = c["whole"]
            # the meshless call's own caches: on one rank a placed cache
            # shares the whole tensor's storage, which the mesh calls write
            ref_batch = dict(batch)
            if "caches" in batch:
                ref_batch["caches"] = [{n: t.clone() for n, t in lc.items()}
                                       for lc in batch["caches"]]
            placed = c["place"](c["whole"], mesh)
            if not all(is_dtensor(t) for t in _tree_leaves(placed)):
                raise AssertionError(f"dry run (19f) {label}: an argument "
                                     f"is not a DTensor")
            step(*placed)                       # warm-up (a decode writes
            torch.cuda.synchronize()            # the same slots again)
            reset_launches()
            real, got, peak = dry_peak_call(torch, step, placed)
            launches = {n: k for n, k in LAUNCHES.items() if k}
            want = step(params, ref_batch)
            errs = hold_lm_call(label, c["kind"], got, want)
            if launches != c["launches"] or \
                    preds[label]["launches"] != c["launches"]:
                raise AssertionError(
                    f"dry run (19f) {label}: {launches} launched, "
                    f"{preds[label]['launches']} predicted, "
                    f"{c['launches']} wanted")
            res = {"errs": errs, "launches": launches}
            res.update(hold_prediction(
                f"(19f) {label} on a one-rank NCCL mesh", preds[label], real,
                peak))
            out[label] = res
            del placed, got, want, ref_batch
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del cases
    torch.cuda.empty_cache()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    log(f"dry run (19f): {out['ms'] / 1e3:.1f} s (inputs built "
        f"{t_built - t0:.1f} s, predictions {t_pred - t_built:.1f} s)")
    return out


def dryrun_gemma(torch, dev) -> dict:
    """(b) when phase 19 runs alone (--dryrun): the model-train cell's
    gemma-7b step (GEMMA_TRAIN_LAYERS layers, batch 2 x TRAIN_SEQ,
    adamw_nomaster, n_micro 2) built here, one warm step, then
    :func:`dryrun_train`."""
    import dataclasses

    from repro_torch.configs import gemma_7b
    from repro_torch.launch.steps import build_lm_train_step
    from repro_torch.models.module import tensor_tree
    from repro_torch.models.transformer import lm_init
    cfg = dataclasses.replace(gemma_7b.CONFIG, n_layers=GEMMA_TRAIN_LAYERS)
    tree = tensor_tree(lm_init(cfg, seed=SEED, device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    t = torch.randint(0, cfg.vocab, (2, TRAIN_SEQ), generator=gen,
                      device=dev, dtype=torch.int32)
    batch = {"tokens": t, "labels": torch.roll(t, -1, 1)}
    step, opt = build_lm_train_step(cfg, "adamw_nomaster", n_micro=2,
                                    lr=TRAIN_LR)
    state, _ = step({"params": tree, "opt": opt.init(tree)}, batch)
    return dryrun_train(torch, GEMMA_DRY_LABEL, step, state, batch)


GEMMA_DRY_LABEL = (f"gemma-7b train step ({GEMMA_TRAIN_LAYERS} of 28 "
                   f"layers, [2, {TRAIN_SEQ}], n_micro 2)")


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fit-recall", nargs=2, type=int, metavar=("L", "N"),
                    help="only the fit cell's fit and recall, at L labels "
                         "and N training queries (N = L: the paper's mode)")
    ap.add_argument("--distributed", action="store_true",
                    help="only the build, the search cell's index and the "
                         "distributed cell")
    ap.add_argument("--audit", action="store_true",
                    help="only the build, the search cell's index and the "
                         "audit cell")
    ap.add_argument("--train", action="store_true",
                    help="only the build and the train cell")
    ap.add_argument("--model-train", action="store_true",
                    help="only the build and the model-training cell")
    ap.add_argument("--lm", action="store_true",
                    help="only the build, the LM cell (prefill, decode, "
                         "vocabulary head) and the MoE cell")
    ap.add_argument("--mesh", action="store_true",
                    help="only the build and the registry and mesh cell")
    ap.add_argument("--dryrun", action="store_true",
                    help="only the build, the search cell's index and the "
                         "dry run (phase 19)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    import repro_torch  # noqa: F401  (sets allow_tf32=False)
    if args.fit_recall:
        log(f"nvidia-smi: {nvidia_smi('name,power.limit')}")
        run = fit_run(torch, torch.device("cuda", 0), *args.fit_recall)
        print(json.dumps({"fit_recall": {
            "labels": args.fit_recall[0], "train": args.fit_recall[1],
            "recall_hash": run["recall"][0], "recall_fit": run["recall"][1],
            "rounds": run["rows"]}}), flush=True)
        return 0
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import scorer_hidden, scorer_logits
    from repro_torch.core.query import (gather_members, mask_tombstones,
                                        probe_keep_mask, rerank_gathered)
    from repro_torch.core.search_api import SearchParams
    from repro_torch.core.topk import topk_stable
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    from repro_torch.kernels.irli_topk import ops as iops
    from repro_torch.kernels.irli_topk.ref import (irli_topk_ref, near,
                                                   same_topm)
    from repro_torch.kernels.mega_query import ops as mops
    from repro_torch.kernels.mega_query.ref import mega_search_ref
    from repro_torch.kernels.quant_rerank import ops as qops
    from repro_torch.kernels.quant_rerank.ref import (quant_rerank_ref,
                                                      same_topk)
    from repro_torch.store.quantized import QuantizedStore, encode
    from repro_torch.store.rerank import refine_stage, resolve_refine_k

    # ---------------------------------------------------- 1. environment --
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {smi}")

    def clock(what):
        log(f"run clock: {time.perf_counter() - t_start:.1f} s before "
            f"{what}")

    # ---------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    libs = _build.build(*KERNELS)
    log(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}: " + ", ".join(
            f"{_build.KERNELS_DIR / n / (n + '.cu')} -> {p}"
            for n, p in libs.items()))
    if args.train:
        out = train_cell(torch, dev)
        print(json.dumps({"train": out}), flush=True)
        return 0
    if args.model_train:
        out = model_train_cell(torch, dev)
        print(json.dumps({"model_train": out["launches"]}), flush=True)
        return 0
    if args.mesh:
        out = registry_mesh_cell(torch, dev, smi)
        print(json.dumps({"mesh": out["launches"]}), flush=True)
        return 0
    if args.lm:
        lm = lm_cell(torch, dev)
        moe = moe_cell(torch, dev)
        print(json.dumps({"lm": lm["launches"], "head": lm["head"],
                          "decode_ms": lm["decode"]["step_ms"],
                          "moe": moe["launches"]}), flush=True)
        return 0

    # -------------------------------------------------------------- data --
    t0 = time.perf_counter()
    corpus, queries = serve_data(torch, dev)
    store8 = encode(corpus, "int8", BLOCK)
    store16 = encode(corpus, "bf16", BLOCK)
    cfg = IRLIConfig(d=D, n_labels=L, n_buckets=B, n_reps=R, d_hidden=H,
                     seed=SEED)
    idx = IRLIIndex(cfg, device=dev)
    idx.build_index()
    torch.cuda.synchronize()
    members = idx.index.members
    params = idx.params
    w2, b2 = params["w2"], params["b2"]
    log(f"setup: {time.perf_counter() - t0:.2f} s; members "
        f"{tuple(members.shape)} ({members.numel() * 4 / 1e6:.0f} MB), "
        f"w2 {w2.numel() * 4 / 1e9:.2f} GB, int8 codes+scales "
        f"{store8.nbytes() / 1e6:.0f} MB, max bucket load "
        f"{int(idx.index.load.max())}")
    if args.distributed:
        del store16
        out = dist_cell(torch, dev, idx, store8, queries)
        print(json.dumps({"distributed": out}), flush=True)
        return 0
    if args.audit:
        del store16, corpus
        torch.cuda.empty_cache()
        out = audit_cell(torch, dev, idx, store8, queries)
        print(json.dumps({"audit": out}), flush=True)
        return 0
    if args.dryrun:
        del store16, corpus
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = dryrun_cell(torch, dev, idx, store8, queries)
        del idx, store8
        torch.cuda.empty_cache()
        calls = dryrun_mesh_calls(torch, dev)
        lm_calls = dryrun_lm_calls(torch, dev)
        gemma = dryrun_gemma(torch, dev)
        log(f"dry run (19): {time.perf_counter() - t0:.1f} s (the gemma "
            f"state's build and warm step included); (e) and (f) "
            f"{(out['lm_cells']['ms'] + lm_calls['ms']) / 1e3:.1f} s")
        print(json.dumps({"dryrun": {
            "serve_query": out["serve_query"],
            "serve_world1_peak_rel": out["serve_world1"]["peak_rel"],
            "cells": {k: {x: v[x] for x in DRY_KEYS}
                      for cells in (out["cells"], out["lm_cells"])
                      for k, v in cells.items() if k != "ms"},
            "calls_peak_rel": {k: v["peak_rel"]
                               for c in (calls, lm_calls)
                               for k, v in c.items() if k != "ms"},
            "gemma_peak_rel": gemma["peak_rel"]}}), flush=True)
        return 0

    # ----------------------------------- 3. kernels against plain versions --
    record = {}

    def freq_err(ids, cnt, rids, rcnt):
        """Largest |kernel - plain| over the ids and the counts."""
        return max(float((ids - rids).abs().max()),
                   float((cnt - rcnt).abs().max()))

    def check_freq(name, cands, C):
        ids, cnt = fops.freq_topc(cands, C=C)
        rids, rcnt = freq_topc_ref(cands, C=C)
        e = freq_err(ids, cnt, rids, rcnt)
        if e != 0.0:
            bad = int((ids != rids).any(1).sum())
            raise AssertionError(f"freq_topc {name}: {bad} rows differ, "
                                 f"max |err| {e}")
        log(f"freq_topc {name} {tuple(cands.shape)} C={C}: bit-exact "
            f"(max |err| {e})")
        return e

    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    C0 = R * M * 2 * (L // B)
    wide = torch.randint(-1, 200_000, (Q, C0), generator=rng, device=dev,
                         dtype=torch.int32)
    err = check_freq("main shape", wide, TOPC)
    del wide
    edge = torch.randint(-1, 50, (8, 777), generator=rng, device=dev,
                         dtype=torch.int32)
    edge[0] = -1                                       # all pads
    edge[1] = 7                                        # one id repeated
    err = max(err, check_freq("edges (all-pad, one id, width 777)", edge,
                              1024),
              check_freq("C > distinct ids", edge[2:], 64))
    # the card tests' rows (tests/torch_freq_cases.py): the widths at the
    # edges of a block (32,768) and of the cluster, the stream cell's
    # 65,280, all pads, one id 65,280 times, all distinct, ids near 2^31,
    # counts spread past one ranking window; and a row past 8 chunks (the
    # wide kernel)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_freq_cases import freq_rows
    cases = dict(freq_rows())
    past = torch.randint(-1, 100_000, (2, 300_000), generator=rng,
                         device=dev, dtype=torch.int32)
    for name, (rows, C) in cases.items():
        err = max(err, check_freq(name, torch.from_numpy(rows).to(dev), C))
    err = max(err, check_freq("300,000 wide (the wide kernel)", past, TOPC))
    fattrs = fops.kernel_attrs()
    log(f"freq_topc attrs: the row kernel {fattrs['registers']} registers, "
        f"{fattrs['spill_bytes']} spill bytes a thread, {fattrs['smem_bytes']}"
        f" B of shared memory a block; the wide kernel "
        f"{fattrs['wide_registers']} registers, {fattrs['wide_spill_bytes']} "
        f"spill bytes, {fattrs['wide_smem_bytes']} B")
    if fattrs["spill_bytes"] or fattrs["wide_spill_bytes"]:
        raise AssertionError(f"freq_topc spills registers: {fattrs}")
    for c0, mx in ((C0, 1_999_999), (40_000, 29_999), (65_280, 2 ** 31 - 2),
                   (300_000, 99_999), (777, -1)):
        if fops.plan_export(c0, mx) != fops.radix_plan(c0, mx):
            raise AssertionError(f"freq_topc's plan at C0={c0}: C side "
                                 f"{fops.plan_export(c0, mx)}, radix_plan "
                                 f"{fops.radix_plan(c0, mx)}")
    # rows wider than a block (a cluster of two blocks a row)
    wide40 = torch.randint(-1, 30_000, (64, 40_000), generator=rng,
                           device=dev, dtype=torch.int32)
    err = max(err, check_freq("40,000-wide rows (a cluster of 2)", wide40,
                              TOPC))
    wide_ms = time_ms(torch, lambda: fops.freq_topc(wide40, C=TOPC), n=5)
    wide_plain = time_ms(torch, lambda: freq_topc_ref(wide40, C=TOPC), n=5)
    log(f"freq_topc 40,000-wide rows {tuple(wide40.shape)} (not on a main "
        f"path): kernel {wide_ms:.4f} ms, plain {wide_plain:.4f} ms")
    del wide40, past
    record["freq_topc"] = {"max_abs_err": err}

    def check_quant(name, store, metric, cid, cnt, tau, kp, q=None):
        q = queries if q is None else q
        ids, vals = qops.quant_rerank(q, store.codes, store.scales,
                                      cid, cnt, tau=tau, k=kp, metric=metric)
        rids, rvals = quant_rerank_ref(q, store.codes, store.scales,
                                       cid, cnt, tau=tau, k=kp, metric=metric)
        _, wide_s = quant_rerank_ref(q, store.codes, store.scales,
                                     cid, cnt, tau=tau, k=kp + 1,
                                     metric=metric)
        torch.cuda.synchronize()
        flagged = same_topk(ids, rids, vals, rvals, wide_s, TOL)
        fin = torch.isfinite(rvals)
        e = float((vals[fin] - rvals[fin]).abs().max()) if fin.any() else 0.
        log(f"quant_rerank {name}: max |err| {e:.3g}, {flagged} near-tie "
            f"rows exempt, {int((ids != rids).any(1).sum())} rows in "
            f"another order, {int((rids < 0).all(1).sum())} empty rows")
        return e

    kp = resolve_refine_k(0, K, TOPC)
    cid = torch.randint(-1, L, (Q, TOPC), generator=rng, device=dev,
                        dtype=torch.int32)
    cnt = torch.randint(0, 4, (Q, TOPC), generator=rng, device=dev
                        ).float()
    cid[-3:] = -1                                      # all-invalid rows
    cnt[-4] = 1.0                                      # all below tau
    qerr = 0.0
    for dtype, store in (("int8", store8), ("bf16", store16)):
        for metric in ("angular", "l2"):
            qerr = max(qerr, check_quant(f"{dtype} {metric} tau={TAU}",
                                         store, metric, cid, cnt, TAU, kp))
    # topC = 20,000: past one block's shared memory, the multi-pass kernel
    cid20 = torch.randint(-1, L, (256, 20_000), generator=rng, device=dev,
                          dtype=torch.int32)
    cnt20 = torch.randint(0, 4, (256, 20_000), generator=rng, device=dev
                          ).float()
    qerr = max(qerr, check_quant(
        f"int8 angular topC=20000 (passes of {qops.pass_slots(20_000, D)} "
        f"slots)",
        store8, "angular", cid20, cnt20, TAU, kp, queries[:256]))
    del cid20, cnt20
    record["quant_rerank"] = {"max_abs_err": qerr}

    hidden = scorer_hidden(params, queries)            # [R, Q, H]

    def check_irli(name, h, w, b, m):
        """Kernel vs plain top-m: values and lse to TOL, ids by
        ref.same_topm (near ties at the m cut exempt)."""
        vals, ids, lse = iops.irli_topk(h, w, b, m=m, lse=True)
        wv, wi, rlse = irli_topk_ref(h, w, b, m=m + 1, lse=True)
        torch.cuda.synchronize()
        cut, order = same_topm(vals, ids, wv, wi, TOL)
        if not bool(near(lse, rlse, TOL).all()):
            raise AssertionError(f"irli_topk {name}: lse off the plain one "
                                 f"by {float((lse - rlse).abs().max())}")
        e = float((vals - wv[..., :m]).abs().max())
        log(f"irli_topk {name} h {tuple(h.shape)} w2 {tuple(w.shape)} "
            f"{h.dtype} m={m}: max |err| {e:.3g} (lse "
            f"{float((lse - rlse).abs().max()):.3g}); {cut} of "
            f"{vals.numel() // m} (rep, query) rows exempt (near tie at the "
            f"m cut), {order} in another order among near values")
        del wv, wi
        return e

    ierr = check_irli("main shape", hidden, w2, b2, M)
    ierr = max(ierr, check_irli(
        "bf16 (4 reps)", hidden[:4].bfloat16(), w2[:4].bfloat16(),
        b2[:4].bfloat16(), M))
    ierr = max(ierr, check_irli(
        "ragged (Q=1000, B=19999, 2 reps)", hidden[:2, :1000].contiguous(),
        w2[:2, :, :19999].contiguous(), b2[:2, :19999].contiguous(), M))
    ierr = max(ierr, check_irli("m=128 (radix-select variant)", hidden, w2,
                                b2, 128))
    record["irli_topk"] = {"max_abs_err": ierr}

    # --------------------------------------- plain search with its cut ties --
    def plain_search(p, base, q, state=None):
        """The search with the plain versions (mega_search_ref), and the
        rows whose result may rightly differ: a near tie at the m cut of
        any rep (the kernels' logits are summed in another order), at the
        k' cut of the coarse scores, or at the k cut of the final scores.
        ``state`` = (scorer params, members, delta members, tombstone) of a
        streaming snapshot; else the serve cell's index.
        -> ((ids, scores, n_cand), exempt [Q] bool, m-cut exempt [Q])."""
        prm, mem, delta, tomb = state or (params, members, None, None)
        res = mega_search_ref(
            prm, mem, base, q, delta, tomb, m=p.m, tau=p.tau, topC=p.topC,
            k=p.k, refine_k=p.refine_k, metric=p.metric,
            adaptive_m=p.adaptive_m, probe_mass=p.probe_mass)
        logits = scorer_logits(prm, q)
        vals, bidx = topk_stable(logits, p.m + 1)
        mcut = near(vals[..., p.m - 1], vals[..., p.m], TOL).any(dim=0)
        adaptive = p.adaptive_m and p.probe_mass < 1.0
        keep = (probe_keep_mask(logits, vals[..., :p.m], p.probe_mass)
                if adaptive else None)
        del logits
        cands = gather_members(mem, bidx[..., :p.m], delta, probe_keep=keep)
        if tomb is not None:
            cands = mask_tombstones(cands, tomb)
        pcid, pcnt = freq_topc_ref(cands, C=p.topC)
        store = base if isinstance(base, QuantizedStore) else None
        if store is not None and store.dtype != "fp32":
            kq = resolve_refine_k(p.refine_k, p.k, p.topC)
            pc, pv = quant_rerank_ref(q, store.codes, store.scales, pcid,
                                      pcnt, tau=p.tau, k=kq + 1,
                                      metric=p.metric)
            cut = torch.isfinite(pv[:, kq]) & near(pv[:, kq - 1], pv[:, kq],
                                                   TOL)
            _, fs = refine_stage(q, store, pc[:, :kq], k=p.k + 1,
                                 metric=p.metric)
        else:
            rows = store.codes if store is not None else base
            _, fs = rerank_gathered(q, rows, pcid, pcnt, p.tau, p.k + 1,
                                    p.metric)
            cut = torch.zeros_like(mcut)
        if fs.shape[1] > p.k:
            cut |= torch.isfinite(fs[:, p.k]) & near(fs[:, p.k - 1],
                                                     fs[:, p.k], TOL)
        return res, mcut | cut, mcut

    def agree(name, got, plain, exempt, mcut):
        """ids and n_candidates equal outside the exempt rows (ids may
        differ in order among near final scores), scores to TOL."""
        ids, scores, nc = got
        pids, pscores, pnc = plain
        w = pids.shape[1]
        if w < ids.shape[1]:                    # the kernel pads k > C
            assert bool((ids[:, w:] == -1).all())
            ids, scores = ids[:, :w], scores[:, :w]
        assert torch.equal(torch.isfinite(scores), ids >= 0), name
        if not torch.equal(nc[~mcut], pnc[~mcut]):
            raise AssertionError(f"{name}: n_candidates differ outside the "
                                 f"m-cut near ties")
        same = (ids == pids).all(dim=1)
        same_set = (torch.sort(ids, 1).values
                    == torch.sort(pids, 1).values).all(dim=1)
        fin = torch.isfinite(pscores)
        close = torch.where(fin, near(scores, pscores, TOL),
                            scores == pscores).all(dim=1)
        bad = ~exempt & ~(close & (same | same_set))
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} rows differ from the plain "
                f"search outside the near-tie rows")
        ok = ~exempt
        e = (float((scores[ok] - pscores[ok])[fin[ok]].abs().max())
             if bool(fin[ok].any()) else 0.0)
        log(f"{name}: ids equal to the plain search ({int(exempt.sum())} "
            f"near-tie rows of {len(ids)} exempt, {int((~same & ok).sum())} "
            f"in another order among near scores), scores within {TOL} "
            f"(max |err| {e:.3g}); survivors/query mean "
            f"{float(pnc.float().mean()):.1f}, rows with a result "
            f"{int((pids[:, 0] >= 0).sum())}/{len(ids)}")
        return e

    def run_path(p, base, q, want):
        """One search through IRLIIndex.search with the counters set to 0
        just before and read just after; the counters must show exactly
        the kernels ``want`` (name -> launches)."""
        reset_launches()
        res = idx.search(q, base, p)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        if {n: c for n, c in launches.items() if c} != want:
            raise AssertionError(f"search {p}: launches {launches}, "
                                 f"expected {want}")
        got = (res.ids, res.scores, res.n_candidates)
        assert res.ids.shape == (len(q), p.k)
        assert res.ids.dtype == torch.int32 and res.scores.dtype == \
            torch.float32 and res.n_candidates.dtype == torch.int32
        assert not torch.isnan(res.scores).any()
        return res, got, launches

    # ------------------------------------------- 4. the compact main path --
    compact = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8",
                           mode="compact", metric="angular")
    want_compact = {"irli_topk": 1, "freq_topc": 1, "quant_rerank": 1}
    main_launches = {}
    compact_out = {}
    for tau in (TAU, 1):
        p = compact.replace(tau=tau)
        _, got, launches = run_path(p, store8, queries, want_compact)
        if tau == TAU:
            main_launches.update(launches)
        plain, exempt, mcut = plain_search(p, store8, queries)
        agree(f"compact path tau={tau} (launches {launches})", got, plain,
              exempt, mcut)
        compact_out[tau] = (got, plain, exempt, mcut)

    # --------------------------------------------- 5. the fused main path --
    auto = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8")
    resolved = auto.resolve(L, Q)
    if resolved.mode != "mega":
        raise AssertionError(f"mode='auto' resolved to {resolved.mode!r} at "
                             f"the cell, expected 'mega'")
    smem = mops.mega_smem_bytes(M, TOPC, 0, K, geom=dict(
        R=R, B=B, ML=members.shape[2], d=D, D=D))
    log(f"mode='auto' resolves to {resolved.mode!r} at L={L}, Q={Q}: "
        f"mega_fits, {smem} B of shared memory a block")
    mega_err = 0.0
    for tau in (TAU, 1):
        p = auto.replace(tau=tau)
        res, got, launches = run_path(p, store8, queries, {"mega_query": 1})
        assert res.mode == "mega", res.mode
        if tau == TAU:
            main_launches["mega_query"] = launches["mega_query"]
        cgot, plain, exempt, mcut = compact_out[tau]
        mega_err = max(mega_err, agree(
            f"fused path tau={tau} (launches {launches})", got, plain,
            exempt, mcut))
        both = ((got[0] == cgot[0]).all(dim=1) | exempt
                | (torch.sort(got[0], 1).values
                   == torch.sort(cgot[0], 1).values).all(dim=1))
        log(f"fused vs compact-on-card tau={tau}: same ids in "
            f"{int(both.sum())}/{Q} rows (the rest exempt near ties)")
        assert bool(both.all())

    # one warm fused search under torch.profiler: one kernel, nothing else
    from torch.profiler import ProfilerActivity, profile
    idx.search(queries, store8, auto)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        idx.search(queries, store8, auto)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise AssertionError("torch.profiler traced no device activity on "
                             "this machine: the one-kernel claim is not "
                             "shown")
    names = sorted({e.name for e in dev_events})
    log(f"profiler: one warm fused search ran {len(dev_events)} device "
        f"activities: {names}")
    if len(dev_events) != 1 or "mega_query" not in dev_events[0].name:
        raise AssertionError(f"the fused search ran {names} on the card, "
                             f"not the one mega_query kernel")

    # the other kinds at Q = 64: fp32 store, bf16, l2, adaptive m, exact tier
    qs = queries[:Q_SMALL].contiguous()
    exact8 = QuantizedStore("int8", store8.block, store8.codes,
                            store8.scales, corpus)
    kinds = [
        ("fp32 store", dict(store_dtype="fp32"), corpus),
        ("bf16 store", dict(store_dtype="bf16"), store16),
        ("int8 l2", dict(metric="l2"), store8),
        ("int8 adaptive m (probe_mass 0.9)",
         dict(adaptive_m=True, probe_mass=0.9), store8),
        ("int8 exact tier", {}, exact8),
    ]
    for name, over, base in kinds:
        p = auto.replace(**over)
        res, got, _ = run_path(p, base, qs, {"mega_query": 1})
        assert res.mode == "mega", res.mode
        plain, exempt, mcut = plain_search(p, base, qs)
        mega_err = max(mega_err, agree(f"fused {name} Q={Q_SMALL}", got,
                                       plain, exempt, mcut))
        _, cgot, _ = run_path(p.replace(mode="compact"), base, qs,
                              {"irli_topk": 1, "freq_topc": 1,
                               **({} if over.get("store_dtype") == "fp32"
                                  else {"quant_rerank": 1})})
        agree(f"compact {name} Q={Q_SMALL}", cgot, plain, exempt, mcut)
    record["mega_query"] = {"max_abs_err": mega_err}
    del compact_out

    # -------------------------------------------------------- 6. times --
    bidx = iops.irli_topk(hidden, w2, b2, m=M)[1]
    cands = gather_members(members, bidx)
    cid_m, cnt_m = fops.freq_topc(cands, C=TOPC)
    cids_m = qops.quant_rerank(queries, store8.codes, store8.scales, cid_m,
                               cnt_m, tau=TAU, k=kp)[0]
    st = {
        "first layer (matmul)": lambda: scorer_hidden(params, queries),
        "irli_topk": lambda: iops.irli_topk(hidden, w2, b2, m=M),
        "gather": lambda: gather_members(members, bidx),
        "freq_topc": lambda: fops.freq_topc(cands, C=TOPC),
        "coarse (quant_rerank)": lambda: qops.quant_rerank(
            queries, store8.codes, store8.scales, cid_m, cnt_m, tau=TAU,
            k=kp),
        "refine": lambda: refine_stage(queries, store8, cids_m, k=K),
        "whole compact search": lambda: idx.search(queries, store8, compact),
        "whole fused search": lambda: idx.search(queries, store8, auto),
        "mega_query": lambda: mops.mega_query(
            params, members, store8.codes, store8.scales, None, queries,
            m=M, tau=TAU, topC=TOPC, k=K),
    }
    slow = ("irli_topk", "whole compact search", "whole fused search",
            "mega_query")
    stage_ms = {name: time_ms(torch, fn, n=10 if name in slow else 20)
                for name, fn in st.items()}
    for name, ms in stage_ms.items():
        log(f"stage {name}: {ms:.4f} ms")

    # irli_topk: plain (matmul + bias + stable top-m) and the library pair
    plain_irli = time_ms(torch, lambda: irli_topk_ref(hidden, w2, b2, m=M),
                         n=5, warmup=2)

    def library_pair():
        logits = torch.bmm(hidden, w2) + b2[:, None, :]
        return torch.topk(logits, M, dim=-1)

    library_irli = time_ms(torch, library_pair, n=5, warmup=2)
    irli_cost = iops.cost(R, Q, H, B, M)
    irli_flops, irli_bytes = irli_cost["flops"], irli_cost["bytes"]
    bounds = {"irli_topk": bound(irli_flops, irli_bytes)}
    log(f"irli_topk: {irli_flops / 1e12:.4f} TFLOP, {irli_bytes / 1e9:.3f} "
        f"GB -> bound {bounds['irli_topk'][0]:.4f} ms "
        f"({bounds['irli_topk'][1]}); kernel {stage_ms['irli_topk']:.4f} ms "
        f"({irli_flops / stage_ms['irli_topk'] / 1e9:.1f} TFLOP/s), plain "
        f"{plain_irli:.4f} ms, library (torch.bmm + bias + torch.topk) "
        f"{library_irli:.4f} ms")
    bmm_ms = time_ms(torch, lambda: torch.bmm(hidden, w2), n=5, warmup=2)
    iattrs = iops.kernel_attrs(torch.float32, M)
    tiles = {"irli_topk": tile_report(
        "irli_topk", stage_ms["irli_topk"], irli_flops, bmm_ms,
        f"torch.bmm [{R}, {Q}, {H}] x [{R}, {H}, {B}]", iattrs)}
    log(f"irli_topk footprint at m={M}: {iattrs['smem_bytes']} B of shared "
        f"memory a block; the m > 64 variant {iattrs['wide_registers']} "
        f"registers, {iattrs['wide_spill_bytes']} spill bytes a thread")
    if iattrs["wide_spill_bytes"] != 0:
        raise AssertionError(f"irli_topk (m > 64) spills: {iattrs}")
    wide_ms = time_ms(torch, lambda: iops.irli_topk(hidden, w2, b2, m=128),
                      n=3, warmup=1)
    log(f"irli_topk m=128 (radix-select variant, not on a main path): "
        f"{wide_ms:.4f} ms")

    plain_freq = time_ms(torch, lambda: freq_topc_ref(cands, C=TOPC), n=10)
    freq_bytes = fops.cost(*cands.shape, TOPC)["bytes"]
    bounds["freq_topc"] = bound(0, freq_bytes)
    plan = fops.radix_plan(cands.shape[1], int(cands.max()))
    top = freq_topc_ref(cands, C=1)[1][:, 0]          # each row's top count
    windows = int((top > 0).sum()) + int((top > fops.BINS - 1).sum())
    smem = freq_smem_bytes(plan, Q, windows)
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    smem_rate = torch.cuda.get_device_properties(0).multi_processor_count \
        * 128 * sm_clock                       # 32 banks x 4 B a clock
    log(f"freq_topc: {freq_bytes / 1e6:.1f} MB in+out -> bound "
        f"{bounds['freq_topc'][0] * 1e3:.1f} us; kernel "
        f"{stage_ms['freq_topc']:.4f} ms, plain {plain_freq:.4f} ms; plan "
        f"{plan}; its {plan['passes']} radix passes a row and {windows} "
        f"count windows ({int((top > fops.BINS - 1).sum())} rows with a "
        f"count past {fops.BINS - 1} need two or more, counted as two) move "
        f"{smem / 1e9:.2f} GB of shared memory -> "
        f"{smem / smem_rate * 1e3:.3f} ms at {smem_rate / 1e12:.1f} TB/s")

    def quant_bound(tau):
        """Least time for the coarse stage on this run's inputs: the ids,
        counts and queries read once, each distinct valid row's codes and
        scales once, the outputs written once; 2·D flops a valid slot."""
        valid = (cid_m >= 0) & (cnt_m >= tau)
        rows = int(torch.unique(cid_m[valid]).numel())
        c = qops.cost(Q, TOPC, D, kp, store8.codes.shape[0],
                      n_blocks=D // BLOCK, valid=int(valid.sum()), rows=rows)
        nbytes, flops = c["bytes"], c["flops"]
        b = bound(flops, nbytes)
        return b, (f"{int(valid.sum())} valid slots, {rows} distinct "
                   f"rows, {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} "
                   f"GFLOP -> bound {b[0] * 1e3:.1f} us ({b[1]})")

    def quant_call(tau, fn):
        return lambda: fn(queries, store8.codes, store8.scales, cid_m, cnt_m,
                          tau=tau, k=kp)

    plain_quant = time_ms(torch, quant_call(TAU, quant_rerank_ref), n=10)
    bounds["quant_rerank"], text = quant_bound(TAU)
    log(f"quant_rerank tau={TAU}: {text}; kernel "
        f"{stage_ms['coarse (quant_rerank)']:.4f} ms, plain "
        f"{plain_quant:.4f} ms")
    tau1_bound, text = quant_bound(1)
    tau1_ms = time_ms(torch, quant_call(1, qops.quant_rerank), n=20)
    tau1_plain = time_ms(torch, quant_call(1, quant_rerank_ref), n=10)
    log(f"quant_rerank tau=1 (all 1024 slots): {text}; kernel "
        f"{tau1_ms:.4f} ms, plain {tau1_plain:.4f} ms")
    qattrs = qops.kernel_attrs()
    log(f"quant_rerank attrs: {qattrs['registers']} registers, "
        f"{qattrs['spill_bytes']} spill bytes a thread (the most of its "
        f"instantiations), {qattrs['fixed_smem_bytes']} B of shared memory "
        f"beside the keys and the query; at C={TOPC}, D={D} "
        f"{qops.smem_bytes(TOPC, D)} B")
    if qattrs["spill_bytes"]:
        raise AssertionError(f"quant_rerank spills registers: {qattrs}")
    q_dev = device_ms(torch, quant_call(TAU, qops.quant_rerank))
    q1_dev = device_ms(torch, quant_call(1, qops.quant_rerank))
    log(f"quant_rerank device time (20 calls in a CUDA graph, without the "
        f"call's host time): tau={TAU} {q_dev:.4f} ms, tau=1 {q1_dev:.4f} "
        f"ms")
    tiles["quant_rerank"] = {
        "device_ms": q_dev, "tau1_ms": tau1_ms, "tau1_device_ms": q1_dev,
        "tau1_plain_ms": tau1_plain, "tau1_bound_ms": tau1_bound[0],
        "registers": qattrs["registers"],
        "spill_bytes": qattrs["spill_bytes"]}

    # mega_query: plain = mega_search_ref on the card; bound from this
    # run's data: both GEMMs, the probed member rows, the distinct valid
    # code rows, the k' refine rows, once each
    plain_mega = time_ms(torch, lambda: mega_search_ref(
        params, members, store8, queries, m=M, tau=TAU, topC=TOPC, k=K),
        n=5, warmup=2)
    valid = (cid_m >= 0) & (cnt_m >= TAU)
    n_buckets = int(torch.unique(
        bidx.long() + torch.arange(R, device=dev)[:, None, None] * B).numel())
    code_rows = int(torch.unique(cid_m[valid]).numel())
    refine_rows = int(torch.unique(cids_m[cids_m >= 0]).numel())
    mega_cost = mops.cost(
        R, Q, D, H, B, members.shape[2], store8.codes.shape[0], m=M,
        topC=TOPC, refine_k=0, k=K, block=BLOCK, valid=int(valid.sum()),
        refine=int((cids_m >= 0).sum()), buckets=n_buckets,
        code_rows=code_rows, refine_rows=refine_rows)
    mega_flops, mega_bytes = mega_cost["flops"], mega_cost["bytes"]
    bounds["mega_query"] = bound(mega_flops, mega_bytes)
    log(f"mega_query: {mega_flops / 1e12:.4f} TFLOP, {mega_bytes / 1e9:.3f} "
        f"GB ({n_buckets} probed buckets, {code_rows} code rows, "
        f"{refine_rows} refine rows) -> bound {bounds['mega_query'][0]:.4f} "
        f"ms ({bounds['mega_query'][1]}); kernel {stage_ms['mega_query']:.4f}"
        f" ms, whole fused search {stage_ms['whole fused search']:.4f} ms, "
        f"plain (mega_search_ref on the card) {plain_mega:.4f} ms")
    pair_ms = time_ms(torch, lambda: torch.bmm(scorer_hidden(params, queries),
                                               w2), n=5, warmup=2)
    mattrs = mops.kernel_attrs(torch.int8, M)
    log(f"mega_query footprint at m={M}: the two workers' scorer tiles "
        f"{mattrs['tiles_smem_bytes']} B of shared memory, the launch {smem} "
        f"B")
    tiles["mega_query"] = tile_report(
        "mega_query", stage_ms["mega_query"], 2 * R * Q * (D * H + H * B),
        pair_ms, f"scorer_hidden + torch.bmm [{R}, {Q}, {H}] x [{R}, {H}, "
        f"{B}]", mattrs, spill_gate=False)

    # mega_query's phases, by timing probes of the same launch (their
    # outputs are not read): phase 1 alone, phases 1-2, and phases 1-2 with
    # phase 2's GEMM walked alone (no drain, no scans). Phase 2's epilogue
    # is what selecting adds to it.
    def mega_probe(phases, select=True):
        return lambda: mops.mega_query(
            params, members, store8.codes, store8.scales, None, queries,
            m=M, tau=TAU, topC=TOPC, k=K, phases=phases, select=select)

    p1, p12, p12_gemm = (time_ms(torch, mega_probe(*a), n=10)
                         for a in ((1,), (2,), (2, False)))
    phase2 = p12 - p1
    epilogue = (p12 - p12_gemm) / phase2
    log(f"mega_query phases: 1 {p1:.4f} ms, 2 {phase2:.4f} ms (its GEMM "
        f"walked alone {p12_gemm - p1:.4f} ms: the epilogue is "
        f"{100 * epilogue:.1f}% of phase 2), 3 "
        f"{stage_ms['mega_query'] - p12:.4f} ms")
    tiles["mega_query"].update(
        phase_ms=[p1, phase2, stage_ms["mega_query"] - p12],
        phase2_epilogue_share=epilogue)

    # peak device memory of one search of each path, above what it found
    def peak_gb(p):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        idx.search(queries, store8, p)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    logits_gb = R * Q * B * 4 / 1e9
    peaks = {"compact": peak_gb(compact), "fused": peak_gb(auto)}
    for name, gb in peaks.items():
        log(f"peak device memory of one {name} search: {gb:.3f} GB above "
            f"its inputs (an [R, Q, B] fp32 logit tensor is {logits_gb:.2f} "
            f"GB)")
        if gb >= logits_gb:
            raise AssertionError(f"the {name} search may hold the [R, Q, B] "
                                 f"logits: peak {gb:.3f} GB")
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("7. the stream")
    # ---------------------------------------------------- 7. the stream --
    del (store16, exact8, cands, cid_m, cnt_m, cids_m, bidx, st, hidden)
    torch.cuda.empty_cache()
    stream = stream_cell(torch, dev, idx, corpus, queries, plain_search,
                         agree)
    record["mega_query"]["max_abs_err"] = max(
        record["mega_query"]["max_abs_err"], stream["search_err"])

    clock("8. the server")
    # ---------------------------------------------------- 8. the server --
    t_cell = time.perf_counter()
    serve = server_cell(torch, dev, idx, store8, corpus, stream.pop("midx"),
                        plain_search, agree)
    log(f"server cell: {time.perf_counter() - t_cell:.1f} s")
    record["mega_query"]["max_abs_err"] = max(
        record["mega_query"]["max_abs_err"], serve["err"])
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("9. the refit")
    # ----------------------------------------------------- 9. the refit --
    del members, params, w2, b2, corpus
    torch.cuda.empty_cache()
    t_cell = time.perf_counter()
    refit = refit_cell(torch, dev)
    log(f"refit cell: {time.perf_counter() - t_cell:.1f} s")

    clock("10. the distributed")
    # ----------------------------------------------- 10. the distributed --
    torch.cuda.empty_cache()
    distributed = dist_cell(torch, dev, idx, store8, queries)

    clock("11. the audit")
    # ----------------------------------------------------- 11. the audit --
    torch.cuda.empty_cache()
    audit = audit_cell(torch, dev, idx, store8, queries)

    clock("19. the dry run (a), on the search cell's index")
    # ------------------------------------------------- 19. the dry run --
    torch.cuda.empty_cache()
    dry = dryrun_cell(torch, dev, idx, store8, queries)
    del idx, store8

    clock("12. the fit")
    # ------------------------------------------------------ 12. the fit --
    torch.cuda.empty_cache()
    fit = fit_cell(torch, dev, check_irli)
    # each kernel's launches on every path the script drives
    by_path = {}
    for path, counts in (("search", main_launches),
                         ("stream", stream["launches"]),
                         ("server", serve["launches"]),
                         ("refit", refit["launches"]),
                         *((f"distributed {part}", c) for part, c in
                           distributed["launches"].items()),
                         ("audit", audit["launches"]),
                         ("fit", fit["launches"]),
                         ("dense search", fit["dense_launches"])):
        for n, c in counts.items():
            if c:
                by_path.setdefault(n, {})[path] = c
    main_launches = {n: sum(paths.values()) for n, paths in by_path.items()}
    record.update(fit["record"])
    record["distance_topk"] = {"max_abs_err": max(stream["dist_err"],
                                                  fit["dist_err"])}
    tiles["distance_topk"] = {**stream["tile"], **fit["neighbours"]}
    tiles["freq_topc"] = stream["freq"]
    bounds.update(fit["bounds"], distance_topk=stream["bound"])
    ierr = max(record["irli_topk"]["max_abs_err"], fit["irli_err"])
    record["irli_topk"] = {"max_abs_err": ierr}
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("13. the train")
    # ---------------------------------------------------- 13. the train --
    torch.cuda.empty_cache()
    train = train_cell(torch, dev, distributed.pop("trainer_ranks"))
    for path, counts in train["launches"].items():
        for n, c in counts.items():
            by_path.setdefault(n, {})[path] = c
    main_launches = {n: sum(paths.values()) for n, paths in by_path.items()}
    record["distance_topk"]["max_abs_err"] = max(
        record["distance_topk"]["max_abs_err"], train["retrieval"]["err"])
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("14. the LM prefill")
    # ------------------------------------------------- 14. the LM prefill --
    torch.cuda.empty_cache()
    lm = lm_cell(torch, dev)
    by_path["flash_attention"] = lm["launches"]
    main_launches["flash_attention"] = sum(lm["launches"].values())
    record["flash_attention"] = {"max_abs_err": lm["err"]}
    bounds["flash_attention"] = lm["bound"]
    by_path["irli_topk"]["vocab head"] = lm["head"]["launches"]
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("15. the MoE cell")
    # ---------------------------------------------------- 15. the MoE cell --
    torch.cuda.empty_cache()
    moe = moe_cell(torch, dev)
    by_path["kchoice"].update({p: c for p, c in moe["launches"].items()
                               if c})
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("16. the recsys cell")
    # ------------------------------------------------ 16. the recsys cell --
    torch.cuda.empty_cache()
    rec = recsys_cell(torch, dev, smi)
    by_path["embedding_bag"] = rec["launches"]
    main_launches = {n: sum(paths.values()) for n, paths in by_path.items()}
    record["embedding_bag"] = {"max_abs_err": rec["err"]}
    bounds["embedding_bag"] = rec["bound"]
    tiles["embedding_bag"] = rec["extra"]
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("17. the model-train cell")
    # ------------------------------------------ 17. the model-train cell --
    torch.cuda.empty_cache()
    mt = model_train_cell(torch, dev)
    for path, counts in mt["launches"].items():
        for n in KERNELS:
            if n in ("flash_attention", "embedding_bag", "kchoice"):
                by_path[n][path] = counts.get(n, 0)
    main_launches = {n: sum(paths.values()) for n, paths in by_path.items()}
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    clock("19. the dry run (d), on a one-rank mesh")
    torch.cuda.empty_cache()
    dry_calls = dryrun_mesh_calls(torch, dev)
    clock("19. the dry run (f), the LM serve calls on a one-rank mesh")
    torch.cuda.empty_cache()
    dry_lm_calls = dryrun_lm_calls(torch, dev)

    clock("18. the registry and the LM on a mesh")
    # -------------------------- 18. the registry and the LM on a mesh --
    torch.cuda.empty_cache()
    rm = registry_mesh_cell(torch, dev, smi)
    for path, counts in rm["launches"].items():
        for n, c in counts.items():
            by_path.setdefault(n, {})[path] = c
    for part, calls in (("d", dry_calls), ("f", dry_lm_calls)):
        for label, res in calls.items():
            for n, c in (res["launches"].items() if label != "ms" else ()):
                by_path.setdefault(n, {})[f"dry run ({part}) {label}"] = c
    main_launches = {n: sum(paths.values()) for n, paths in by_path.items()}
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    times = {
        "irli_topk": (stage_ms["irli_topk"], plain_irli, library_irli),
        "freq_topc": (stage_ms["freq_topc"], plain_freq, None),
        "quant_rerank": (stage_ms["coarse (quant_rerank)"], plain_quant,
                         None),
        "mega_query": (stage_ms["mega_query"], plain_mega, None),
        "distance_topk": stream["times"],
        "flash_attention": lm["times"],
        "embedding_bag": rec["times"],
        **fit["times"],
    }
    replaces = {
        "irli_topk": "src/repro/kernels/irli_topk/irli_topk.py:82",
        "freq_topc": "src/repro/kernels/freq_topc/freq_topc.py:126",
        "quant_rerank": "src/repro/kernels/quant_rerank/quant_rerank.py:75",
        "mega_query": "src/repro/kernels/mega_query/mega_query.py:250",
        "bce_logits": "src/repro/kernels/bce_logits/bce_logits.py:31",
        # no TPU kernel: the reference's lax.scan over the labels
        "kchoice": "src/repro/core/repartition.py:93",
        "distance_topk":
            "src/repro/kernels/distance_topk/distance_topk.py:60",
        "flash_attention": "src/repro/kernels/flash_attn/flash_attn.py:69",
        "embedding_bag":
            "src/repro/kernels/embedding_bag/embedding_bag.py:49",
    }
    kernels = [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/{n}/{n}.cu",
         "replaces": replaces[n], "launches": main_launches[n],
         "max_abs_err": record[n]["max_abs_err"], "ms": times[n][0],
         "plain_ms": times[n][1], "bound_ms": bounds[n][0],
         "bound_by": bounds[n][1], "library_ms": times[n][2],
         "launches_by_path": by_path[n], **tiles.get(n, {})}
        for n in KERNELS]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel did not run on its path: {kernels}")
    dry_ms = dry["ms"] + mt["lm"]["gemma"]["dryrun"]["ms"] + dry_calls["ms"]
    log(f"dry run (19): (a), (c), (a') {dry['ms'] / 1e3:.1f} s (of which (c) "
        f"{dry['cells']['ms'] / 1e3:.1f} s) + (b) "
        f"{mt['lm']['gemma']['dryrun']['ms'] / 1e3:.1f} s + (d) "
        f"{dry_calls['ms'] / 1e3:.1f} s = {dry_ms / 1e3:.1f} s of the run "
        f"(budget {DRY_MS_MAX / 1e3:.0f} s)")
    if dry_ms > DRY_MS_MAX:
        raise AssertionError(f"phase 19 took {dry_ms / 1e3:.1f} s, over its "
                             f"{DRY_MS_MAX / 1e3:.0f} s")
    dry_lm_ms = dry["lm_cells"]["ms"] + dry_lm_calls["ms"]
    log(f"dry run (19): (e) {dry['lm_cells']['ms'] / 1e3:.1f} s + (f) "
        f"{dry_lm_calls['ms'] / 1e3:.1f} s = {dry_lm_ms / 1e3:.1f} s of the "
        f"run (budget {DRY_LM_MS_MAX / 1e3:.0f} s)")
    if dry_lm_ms > DRY_LM_MS_MAX:
        raise AssertionError(f"phase 19's (e) and (f) took "
                             f"{dry_lm_ms / 1e3:.1f} s, over their "
                             f"{DRY_LM_MS_MAX / 1e3:.0f} s")
    log(f"chip_smoke: the whole run, build included, took "
        f"{time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
