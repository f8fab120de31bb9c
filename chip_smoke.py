#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

K1 (``csrc/spmm_accel.cu``), K2 (``csrc/spmm_windowed.cu``) and K3
(``csrc/spmm_hbm.cu``) are one live-row gather pipeline
(``csrc/slab_common.cuh``): a CTA per (block, feature tile),
feature-tile-major over the grid, gathers one row segment per live slot
into a shared-memory ring (a bulk copy per segment on mbarriers where
F % 4 == 0 and X is 16-byte aligned, else 4-byte cp.async per thread), sums
each local row's run in registers and adds it into the output with one
fp32 RED; K1 and K3 launch the same kernel in slot order, K2 walks by
(local row, window, slot), adding window partials in window order.

Phases (any failure exits non-zero and prints no result line):

1. the card: name, power limit, torch and CUDA versions; TF32 is switched
   off for matmuls and cuDNN so every fp32 product is full fp32;
2. build K1, K2, K3 and K4 (``src/repro_torch/csrc/spmm_accel.cu``,
   ``spmm_windowed.cu``, ``spmm_hbm.cu``, ``grouped_matmul.cu``) with nvcc
   for sm_90a, all four at once, and print ptxas' registers, shared memory
   and spills, and each kernel's dynamic shared memory per CTA and the
   CTAs one SM holds per gather instance (K1 at every f_tile of its sweep,
   K2 and K3 at 128; more than 2 each);
3. each kernel against its plain PyTorch version on the card, in both
   partition modes: zero-degree rows, degree == deg_bound, degree > C
   (split rows), F in {1, 100, 2048}, and merged batched slabs with
   all-zero padding blocks, also from an X view 4 bytes off a 16-byte
   boundary; K1 at every f_tile its wrapper can pick; K2 at 1, 2 and 4 row
   windows, with window boundaries that cut blocks. Integer-valued graphs
   must match exactly. K2's window order is pinned by a row that sums to
   exactly 1 only in window order (0 in slot order), held bit for bit
   against the plain version on the CPU; both gather instances of K1, K2
   and K3 must have run;
4. slice A's path: the Reddit and Arxiv analogues registered in one
   GraphServeEngine (backend ``accel``, K1), the 25m GCN (dims
   1024-2048x4-256, 256 classes) served layer by layer for 2 rounds, then
   4 threads x 4 concurrent submits at width 256. Every answer is checked
   against the CSR oracle on the card. The K1 launch count of this phase
   must equal the number of dispatches, every launch through the ``bulk``
   gather instance;
5. where one served F=2048 layer spends its device time (torch.profiler);
6. slice B1's path, routed serving: GraphServeEngine(backend="auto") serves
   the same GCN for 2 rounds over the Reddit and Arxiv analogues fused into
   one dispatch per layer (hbm -> K3), the ``25m`` preset's own graph alone
   (windowed, 2 windows -> K2) and the ``tiny`` preset's graph alone
   (resident -> K1). Every answer is checked against the CSR oracle; the
   K1/K2/K3 launch counts of the phase must equal the engines' routed
   counts (12/12/12), each at least 1, and every K1, K2 and K3 launch of
   the phase must have taken the ``bulk`` gather instance;
   backend="pallas" on Reddit must raise VmemBudgetError;
7. kernel times (CUDA events), in turns on one card: K1, K3, K1 again, the
   plain version and ``torch.sparse.mm`` on the same A and X (a yardstick
   the port never calls) per fused Reddit+Arxiv dispatch at F=2048; K1's
   column-slice sweep (f_tile 32 to 512 in both gather instances) in turns
   with K3 and ``torch.sparse.mm``, each first held against the plain
   version; the hub
   row; K1 in its routed regime (the ``tiny`` graph and a 4,096-node
   power-law graph at F=2048) beside ``torch.sparse.mm``; K2,
   ``torch.sparse.mm``, K2 again and the plain version on the 25m graph at
   F=2048. Each beside the memory bound and its rate of needed gather bytes
   (nnz * F * 4 / ms);
8. slice D's training path: the ``100m`` preset of
   ``examples/train_gcn.py`` (5,000 nodes, dims 1024-4096x7-256, 256
   classes, 9 layers, ~106M fp32 parameters, from seed 0) built through
   ``repro_torch.examples.train_gcn.build_problem`` with ``GraphOp`` on K1
   (``backend="accel"``). Step 0's loss and every gradient against the
   twin (``backend="blocked"``) from the same parameters, within
   ``grad_bound_rel``; one backward aggregation ``bwd(g)`` at F=4096
   against the fp64 CSR oracle of A'^T within the
   summation bound; then 5 SGD steps (lr 1e-2) through the trainer's
   ``train`` loop: losses finite and falling, K1 launched per step as
   ``models/gcn.py::transform_first`` places each layer (18: 9 on the A'
   plan, 9 on the A'^T plan); the median step time by CUDA
   events, K1's share of a step's device time by torch.profiler, peak
   memory; a checkpoint of the final parameters restored bit for bit with
   the same loss; ``sage`` and ``gin`` at the ``tiny`` preset against the
   twin;
9. slice D's mutation path: the Arxiv analogue (169,343 nodes, ~1.34M nnz
   after gcn_normalize) in a ``GraphServeEngine`` of backend ``accel`` (K1)
   and one of backend ``auto`` (K3 at F=2048), served at F=2048, then 4
   ``mutate()`` deltas of 250 inserts and 250 deletes each while 2 threads
   submit reads. Every read equals the CSR oracle of one published version
   (pre- or post-delta), every delta is repaired (no rebuild), and the final
   version's answer equals a fresh ``build_partition_plan`` of the
   post-delta graph through the same kernel within twice the summation
   bound; an integer-valued copy (values 1-3, features -4..4) holds all of
   it exactly. A second integer chain draws its deletes uniformly over
   the edges, so they land on the hub rows and the fragmentation guard may
   rebuild: its reads and final version are held exactly as above, and
   each delta's repaired/rebuilt outcome is logged, not asserted. The
   phase's K1 and K3 launches must equal the engines' dispatches. Then the repair of one delta against a fresh build on the
   host clock, and the served latency before and after;
10. K4, the grouped GEMM, against its plain version on edge cases, each
   case asserting which of K4's two instances ran it. The CUDA-core
   (``simt``) instance: an expert with no rows, a single expert, trailing
   clipped blocks, m_tile 8/16/128/160, K and N not multiples of 4, fp32
   and bf16 x and w in every combination. The tensor-core (``wgmma``)
   instance, bf16 x and w: the same block structures at m_tile
   64/128/192/256, K 512 and 520, N 256 and 264, and NaN/Inf in the weights
   of the experts beside the one multiplied. Integer inputs exact, float
   inputs within ``(K+1) * 2**-24 * (|x| @ |w|)`` of the fp64 product.
   Then ``wgmma`` exact on integers at dbrx-132b's full wi and wo widths,
   at 144 and 20 row blocks (the two token counts of phase 11);
11. slice C1's path: ``moe_block`` at dbrx-132b's full width (d_model 6144,
   d_ff 10752, 16 experts, top-4) through K4, weights from ``init_moe``
   (router fp32, experts bf16): {4,096 tokens, 128 tokens} x {balanced,
   skewed} routing and one fp32 run. K4 launches: 3 per call, the 12 of
   the bf16 calls through ``wgmma``, the fp32 call's 3 through ``simt``.
   In each case the three products (wi, wg, wo), rebuilt from the
   dispatch, are each held against the plain version on the same operands
   (``k4_pair_check``), and the outputs of K4's path and of the twin
   against an fp64 oracle on a sample of 256 tokens (bound in
   ``moe_oracle``);
12. K4 times at 4,096 tokens (each GEMM in bf16 through ``wgmma``, wi
   through ``simt`` on the same bf16 operands and with fp32 operands, the
   plain version, ``torch._grouped_mm`` as the library yardstick) and at 128
   tokens (each GEMM, bound by the weights' bytes), each beside its bound,
   and the whole ``moe_block`` at both; then phases 18 to 22, then the
   ``{"kernels": [...]}`` line (every record also carries
   ``launches_by_path``, its launches on each path that runs it: ``lm``,
   ``lm_train``, ``lm_sharded`` and ``lm_microbatch`` included, phase
   22's ``moe_example`` for K4 and ``tune_cli`` for K1-K3), the card
   line, and the ``{"ok": true, ...}`` line last.
13. slice E's autotuning path (run after phase 9), on the Arxiv analogue
   and its integer copy as phase 9 builds them: (a) every candidate of
   ``default_candidates`` for the tpu default and paper (12, 32) (slab
   shapes C = 128-768, R up to 256; phase 2 prints each shape's shared
   memory and CTAs per SM) through K1, K2 and K3 at F=2048, exact against
   the fp64 CSR oracle on the integer copy; (b) ``tune_offline`` at
   F=2048, ``accel``, 5 repeats by CUDA events: each candidate's ms and
   speedup over the base; (c) an ``accel`` engine whose ``PlanTuner``
   wins every comparison, forced to promote the winner of (b) (the first
   candidate if none won), serves the 25m GCN's layers on the float graph
   (chained, within the summation bound valid for both plans) and integer
   features at each layer's width on the integer copy (exact) until the
   promotion is published and a whole pass is served after it: the served
   plan carries the candidate's config and label at the next version, no
   shadow failed; (d) ``PlanTuner()`` at its defaults under 1,200
   closed-loop F=256 reads: comparisons, wins, promotions, and the live
   dispatch's p50 with and without a shadow in flight (shadows run on a
   stream of their own). K1's launches over (c) and (d) must equal the
   live dispatches plus 5 per shadow (1 warm-up + ABBA);
14. slice E's sampled serving (after phase 13): the Reddit analogue in a
   ``GraphStore`` (normalized, both orientations) behind one
   ``GraphServeEngine(backend="auto")`` and the 25m GCN at full width and
   depth (5 layers, 5 hops): (a) full fanout on 32 seeds against
   full-graph serving of ``store.in_adj`` at those seeds, within twice the
   first-order bound of the frontier's fp64 magnitude; (b) a 2-hop
   full-fanout ``aggregate`` on an integer store (values 1, features
   -4..4) equal to the fp64 oracle of (A^2 x)[seeds]; (c) fanouts
   [10, 10, 5, 5, 5], 2 batches of 256 train seeds (``seed_splits``,
   ``seed_batches``) each served twice (2 frontier misses, 2 hits), each
   answer against the fp64 oracle of its frontier's blocks, with the
   layer sizes, the host's sampling and plan-build ms, each hop's routed
   regime and device ms, the dense GEMM ms and seeds per second on a hit;
   (d) inserts aimed at (b)'s seeds through ``store.apply_delta``: the
   cached frontier is repaired through ``engine.mutate`` (or dropped) and
   the next aggregate equals the post-delta oracle exactly. The phase's
   K1, K2 and K3 launches must equal the engine's routed counts.
15. slice F's fleet serving (run after phase 7, on its graphs), over the
   slots of ``fleet_slots()``: one per card where several are visible, else
   4 slots of the one card (slots share its SMs: no speed-up is expected).
   (a) a ``FleetGraphEngine(backend="accel")`` serves Reddit, Arxiv, the
   25m preset graph and ``tiny`` through the 25m GCN layer by layer, each
   graph in a dispatch of its own: ``route_fleet`` takes the F=2048 layers
   to ``feature``, the F=256 layers to ``block`` (``tiny``: ``single``);
   each dispatch's FleetDecision equals ``route_fleet``'s and is logged
   with the live blocks per slot (balanced within one); every answer
   within the summation bound plus the slot count for block-sharded
   answers (split rows sum across slots), integer copies (values 1-2,
   features -2..2) exact at F=2048 and 256; K1's launches equal the
   engine's per-slot routed count (``slot_routed_resident``); (b) the same
   with ``backend="auto"``, each slot's share on K1, K2 or K3 as its shape
   routes, each launched, launches equal to the per-slot routed counts;
   (c) the reference's zipf script at 20k-50k nodes, F=256, 96 requests
   from 4 threads, ``rate_per_replica=1.0``, replication on and off: at
   least one promotion, requests of per-slot dispatches on more slots
   than with replication off, answers equal and exact, occupancy logged
   both ways; (d) ``mutate()`` on the hottest zipf graph, replicated to
   every slot, while 2 threads read: every read one version's exact
   product, the new version staged on the primary and every replica;
   (e) ``hedge_ms`` set on small replicated graphs: answers exact, hedge
   counters logged; (f) CUDA-event and wall times of one served F=2048 and
   F=256 layer of Reddit, the fleet against a single ``GraphServeEngine``
   in turns, with the fleet's busy clocks. The K1/K2/K3 launches of
   (a)-(d) are the ``"fleet"`` entry of each record's
   ``launches_by_path``.
16. slice G's cross-host serving (after phase 14, the parent holding no
   phase's tensors): ``run_fleet`` starts two worker processes
   (``python -c``, gloo over ``tcp://localhost``), each with MH_SLOTS
   slots of the one card and a ``MultihostGraphEngine(backend="auto")``
   (``multihost_worker``). Both register Reddit, Arxiv (full size,
   normalized as phases 4-6 build them), the ``25m`` and ``tiny`` preset
   graphs and an integer copy of each (values 1-2); only each plan's owner
   (the ``PlacementDirectory``) builds it. After reference answers from a
   ``GraphServeEngine`` on the card (their launches not counted), both
   ranks serve all 8 graphs concurrently (F=256 for Reddit and Arxiv,
   2048 for the presets), each forwarding what the other owns while it
   answers the other's forwards: answers within the summation bound plus
   the slot and window levels, integer copies exact; forwarded >= 1,
   answered >= 1, no failover, both hosts carrying placements, the
   scheduler's invariant. Then, in turns, each rank's request per graph
   (local where it owns the plan, forwarded where the peer does) and the
   bytes on the wire of each forward; a phase gate over the data plane;
   ``serve_global(Reddit)`` at F=256 (block over the 4 global slots, K3
   shares, live blocks balanced within 1) within the bound, its integer
   copy exact and bit-equal to ``spmm_block_sharded`` over 4 slots of the
   card in one process, with the shares' CUDA-event ms, the stage + gloo
   gather ms, the fold ms and the wall ms beside the single-card
   ``serve_one``; one 250-edge delta on the integer Arxiv copy from rank
   0: both ranks at version 1, one repair and no rebuild on the owner,
   one read per rank exact on the new version; Reddit's ``GraphStore``
   split in two, a 2-hop frontier (fanouts [10, 10]) of 256 seeds
   straddling the boundary sampled through ``FrontierExchange`` identical
   to the monolithic store's with no failover, then aggregated through a
   ``SamplingService`` on the worker's engine within its bound. Each
   worker's K1/K2/K3 launches (less the reference answers') equal its
   per-slot routed counts; their sums are the ``"multihost"`` entry of
   ``launches_by_path``.
17. slice H's lock-order witness on the served path (after phase 16):
   one F=256 layer of the integer Reddit copy is timed here, unwitnessed;
   then a fresh process (``witness_child``) installs
   ``repro_torch.statics.witness`` before any ``repro_torch`` import, so
   module-level locks are wrapped too, and runs (a) an ``accel``
   ``GraphServeEngine`` with a ``PlanTuner`` (every fourth dispatch
   shadowed) over the integer Reddit and Arxiv copies: 4 threads x 32
   closed-loop requests at F=256, one ``mutate()`` on Arxiv published
   half way, every answer exact against one published version's oracle,
   at least one shadow; the same layer timed under the witness; (c) one
   ``SamplingService`` batch of 64 seeds (fanouts [10, 10]) over Arxiv's
   store within its bound; (b) a ``FleetGraphEngine`` over
   ``fleet_slots()`` with replication on, 3 graphs of phase 15's zipf mix
   served twice, exact, at least one promotion; then (d) two
   ``run_fleet`` workers (``witness_fleet_worker``, the witness installed
   first) each holding the integer ``tiny`` graph in a
   ``MultihostGraphEngine``: one forwarded read, one broadcast delta, a
   read of the new version, all exact. Each process must report no
   cycle and wrapped locks in each module its workload creates locks in
   (``WITNESS_CHILD_MODULES``, ``WITNESS_WORKER_MODULES``); the locks per
   module, acquisitions, order edges, both layer times beside the card
   line, and the phase's seconds are printed. The child's K1 launches
   equal its engines' dispatches plus 5 per shadow plus the fleet's
   per-slot routed count; each worker's equal its per-slot routed counts;
   their sum is the ``"witness"`` entry of ``launches_by_path``.
18. slice I's LM path (after phase 12; no kernel of the port is on it):
   (a) ``phi3-mini-3.8b`` at full width and depth (32 layers, d_model
   3072, 32 heads of 96, d_ff 8192, vocab 32064; 3,821,079,552 bf16
   parameters drawn from a CUDA generator with seed 0, equal to
   ``lm.config_param_count``) served by ``ServeEngine(batch=4,
   max_seq=256, eos_id=-1)`` through ``examples/serve_lm.py``'s
   ``drive()``: 3 requests through ``generate()``, then 8 ``submit()``s
   through the 4 slots; every answer has its length and its tokens lie in
   the vocabulary, ``slots_reused > 0``, the same prompt twice gives the
   same tokens. One 128-token prompt's last-token logits from
   ``prefill_forward``, from the prompt fed through ``decode_step`` and
   from ``lm_forward`` agree within relative rms ``LM_BF16_REL_RMS``; a
   recycled slot agrees with a fresh state within 0.08. (b) every other
   arch at full width, its depth cut to ``LM_CUTS`` (one at a time, freed
   before the next): a short ``generate()`` in bf16, then an fp32 copy of
   the same weights: prefill and 4 decode steps against ``lm_forward`` on
   the card (MoE with dropless capacity) and against the same functions
   on the CPU, each within ``LM_FP32_REL`` of max |logit| (hubert: its
   frame logits, prefill only). Then phi3 at full width cut to
   ``LM_BF16_LAYERS`` layers, in bf16 as served: forward, prefill and 4
   decode steps on the card against the CPU within the serving bound
   (atol = rtol = 0.08). (c) CUDA-event times beside the card line:
   phi3's decode step at batch 4 and 32 (max_seq 256) beside the bytes it
   must move (weights and the static KV cache it reads), prefill at B=1,
   T=512 beside its bound (the layers' matmuls for T tokens, the head for
   one, causal attention; or the weights' bytes), one decode step under
   torch.profiler (top device ops; device-idle share over the step's own
   traced span), the engine under load (``LM_LOAD``: 128-token prompts, 32
   new tokens, as many closed-loop clients as slots; tokens/s, slot
   utilization, latency), peak memory. (d) K1-K4's launch counters are the
   same before and after the phase.
19. slice J's LM training path (after phase 18, its memory freed; no
   kernel of the port is on it): (a) ``phi3-mini-3.8b`` at full width and
   depth, ``init_train_state`` on the card from generator seed 0
   (3,821,079,552 bf16 parameters with fp32 m, v and master: 53.5 GB),
   ``make_train_step`` (remat, loss/query/key chunks of 512, peak lr 3e-4,
   warm-up 2) at B=4, T=512 fed by ``token_batch_fn(vocab=32064, seed=0)``
   through ``train_loop`` for 6 steps: every loss finite and > 0, every
   fp32 master leaf moved at step 1 (``leaf_digests``); step ms by CUDA
   events over steps 3-6 and by the host clock, tokens/s, the model-FLOPs
   share of the dense bf16 peak, ``adamw_update`` alone against its bytes
   bound (28 B a parameter), peak memory, one step under torch.profiler
   (launches, device time by op, idle share over the step's own span; no
   whole-leaf gradient fill of a stacked leaf). (b) one step at T=4096,
   B=1: ms and peak memory. (c) phi3 at full width cut to 2 layers, fp32
   copies of its weights, TF32 off: one step on the card and one on the
   CPU from the same batch, loss and grad_norm within 1e-5 relative and
   master within the CPU tests' bounds. (d) the same cut, ``microbatch=2``
   against none at B=4 within the bf16-accumulation bound. (e) the nine
   other archs at full width and ``LM_CUTS``' depth: one bf16 step at B=1,
   T=512 each, finite loss, every master leaf moved, state + grads against
   the peak (dbrx-132b's one layer: 71.9 GB). (f) reduced phi3 through
   ``train_loop`` with a ``CheckpointManager``: crash at step 3, resume,
   the resumed history within ``TRAIN_RESTART_REL``. (g) K1-K4's launch
   counters are the same before and after the phase.
20. slice K's dry run against the card (after phase 19; no kernel of the
   port is on it): (a) ``repro_torch.launch.dryrun.probe_roofline`` on the
   meta device (the whole depth at the reference's probe chunks) and
   ``roofline_terms`` against ``hw_for("cuda")`` for phi3-mini-3.8b at all
   four shapes (``long_500k`` is a recorded skip), deepseek-moe-16b
   ``train_4k`` and zamba2-7b ``decode_32k``: FLOPs, bytes, the three
   terms, the bottleneck and ``useful_ratio`` beside the card line. (b)
   the dry run held against the card, each step traced on ``meta`` and
   then run on the card under the same ``CountingMode``: phase 18's decode
   step (phi3 uncut, batch 4 and 32, max_seq 256; run inside phase 18,
   where its weights live) and phase 19's train step (B=4, T=512, chunks
   512; run inside phase 19, on its 53.5 GB state): FLOPs equal exactly,
   argument bytes equal exactly the bytes of the live weights (train: the
   whole state), cache and batch, the predicted peak within
   ``DRYRUN_PEAK_REL`` of ``max_memory_allocated`` over the step (less
   what the card held beside the arguments before it), and the step's
   CUDA-event ms from phase 18 or 19 beside ``max(compute_s, memory_s)``.
   (c) ``python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b
   --shape decode_32k`` in a subprocess exits 0 and its record has the
   reference's keys.
21. slice L's partitioned LM step (after phase 20; no kernel of the port
   is on it), every part in child processes, so this process makes no
   process group: (a) one process per visible card joins an nccl group
   (``make_host_mesh()``: a 1x1 mesh on one card, ``data`` = N on N) and
   runs phi3-mini-3.8b at full width cut to ``SHARD_LAYERS`` layers
   (bf16 on one card, fp32 on several) through the distributed
   ``init_train_state`` -> ``make_train_step`` (B=4, T=512, 3 steps, the
   last counted), ``prefill_forward`` of a 128-token prompt and 4 greedy
   ``make_serve_step`` decode steps, then the one-card program from the
   same seed in the same process: losses, sampled leaves (gathered),
   logits and tokens bit-equal on one card (deterministic kernels), within
   ``SHARD_REL`` on several; step ms, peak GiB and the collectives of the
   counted step are printed. (b) rank 0 of ``pod16x16`` under a ``fake``
   group of 256 ranks, phi3 at full width and depth, ``train_4k`` (global
   batch 256, T=4096) and ``decode_32k`` (batch 128, S=32,768): the dry
   run's prediction traced on meta in a child (started beside (a)), then,
   where it fits in 80 GB, the same step in another child with its local
   shards allocated on the card and counted under the same mode (its
   second step: the first allocates the libraries' workspaces): FLOPs and
   collective bytes equal, argument bytes equal, the allocator's peak
   (``max_memory_allocated``) within ``SHARD_PEAK_REL`` of the predicted
   peak of allocator blocks (each storage rounded up to 512 bytes; the
   child runs the allocator with ``expandable_segments:True``, which
   splits every block it hands out, so no cached block comes unsplit;
   the peak of the bytes requested, the tracker's raw peak, is logged
   beside it), and its CUDA-event ms (compute of
   one rank, no communication: the fake group moves nothing, so its values
   are not a model's and nothing is asserted of them).
22. slice M (after phase 21): (a) phase 21 (a)'s program with
   ``microbatch=MB_MICROBATCH`` (B=4 in 2 microbatches; the partitioned
   step places each microbatch's global rows on the batch axes) on the
   same nccl group, against the one-card microbatched step in the same
   process: losses, grad_norms, sampled leaves, logits and tokens
   bit-equal on one card; step ms and peak beside phase 21 (a)'s
   unmicrobatched ones. (b) rank 0 of ``pod16x16`` on ``train_4k`` with
   ``microbatch`` = 256 // ``MB_DIV`` (hillclimb's ``microbatch4``) at
   full width, its depth cut to ``MB_LAYERS`` (a full-depth trace at the
   production chunks takes minutes of host time), and the same cut
   without microbatching, as phase 21 (b): meta's predictions in children
   beside (a), then each step on the card, counted: FLOPs and collective
   bytes equal, argument bytes equal, the peak within ``SHARD_PEAK_REL``
   of the prediction; microbatched, the same FLOPs and a lower peak. (c) ``examples/moe_block_dispatch.py``'s port with ``--device
   cuda``: 3 K4 ``simt`` launches per ``moe_block`` call, its claims
   (block dispatch within 1e-5 of the dropless capacity dispatch; a
   capacity of 1.25 drops under skew); then its two routings at
   dbrx-132b's full MoE width in bf16 (4,096 tokens, ``m_tile`` 128: K4
   ``wgmma``) against ``moe_capacity`` at a capacity that drops nothing,
   within ``2**-6 * max|ref|`` (the MoE tests' bf16 bound). (d)
   ``python -m repro_torch.scripts.tune_partition``'s ``main`` on
   synthetic power-law graphs (``TUNE_CLI_RUNS``): ``accel`` (K1) and
   ``auto`` at 20,000 nodes (K3) and 12,000 (K2); the ranking and each
   kernel's launches, (1 + repeats) per timed plan. (e) on meta, in a
   child beside (a): ``coll_breakdown``'s top rows and hillclimb's
   ``baseline`` and ``microbatch4`` terms for phi3 ``train_4k`` (rank 0
   of ``pod16x16``) against the card's row.

Tolerance for float results. K1 and K3 sum a row in two levels: at most
min(deg, C) rounded products in order inside a block, then one partial per
block (ceil(deg / C) of them) in any order. The classic bound for recursive
summation gives, per element, ``|y - exact| <= k * u * (|A| @ |x|)`` with
``k = min(deg, C) + ceil(deg/C) + 1`` and ``u = 2**-24``. K2 adds one level,
the window partials of each block row, so its k grows by the number of
windows. Served answers are held to that bound against an fp64 CSR oracle;
a kernel and its plain version, both fp32, to twice it.
"""
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
U = 2.0 ** -24                # fp32 unit roundoff
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_FLOPS = 67e12            # H100 SXM fp32 rate outside the tensor cores
BF16_FLOPS = 989.4e12         # H100 SXM dense bf16 tensor-core rate
DIMS = [1024, 2048, 2048, 2048, 2048, 256]   # examples/train_gcn.py "25m"
N_CLASSES = 256
GRAPHS = ("Reddit", "Arxiv")
# examples/train_gcn.py presets: (name, nodes, edges) of their own graphs
PRESET_GRAPHS = (("25m", 8_000, 64_000), ("tiny", 2_000, 12_000))
K1_SWEEP = (32, 64, 128, 256, 512)   # K1's column slices timed in phase 7


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def summation_k(g, C, degree_sorted):
    """Per-row k of the summation bound (see the module docstring), in the
    graph's original row order or in its degree-sorted order."""
    import numpy as np
    from repro_torch.core.graph import counting_sort_by_degree
    deg = np.diff(g.rowptr).astype(np.int64)
    if degree_sorted:
        deg = deg[counting_sort_by_degree(deg)]
    return np.minimum(deg, C) + -(-deg // C) + 1


def check_close(name, got, want, bound):
    """Elementwise |got - want| <= bound; returns the max abs error."""
    err = (got.double() - want.double()).abs()
    bad = err > bound
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside tolerance, e.g. "
            f"flat index {i}: got {got.flatten()[i].item()}, want "
            f"{want.flatten()[i].item()}, bound {bound.flatten()[i].item()}")
    return float(err.max()) if err.numel() else 0.0


def pair_bound(torch, plain, args, x, n_rows, k):
    """Twice the summation bound, for two fp32 results of the same slabs."""
    mag = plain(args[0], args[1].abs(), args[2], args[3], x.abs(), n_rows)
    kt = torch.as_tensor(k, dtype=torch.float64, device=x.device)[:, None]
    return 2 * U * kt * mag.double()


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{name}, power limit not reported"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {name}; nvidia-smi: {card_line}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; TF32 off for matmul and cuDNN "
        f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32})")
    return name, card_line


def phase_build():
    """Build every kernel library at once and print, per kernel, what ptxas
    reports (registers, spills, static shared memory) and, at C=256, R=64,
    its dynamic shared memory per CTA and the CTAs one SM holds for each
    gather instance: K1 at every f_tile of the phase 7 sweep, K2 and K3 at
    f_tile=128. Fails where a pipeline CTA that the wrappers launch leaves
    2 or fewer CTAs per SM."""
    from repro_torch.kernels import spmm_accel, spmm_hbm
    from repro_torch.kernels.build import build_all, load_kernel
    t0 = time.perf_counter()
    built = build_all()
    log(f"K1, K2, K3, K4 built in parallel in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, (path, report) in built.items():
        log(f"{name}: {os.path.relpath(path, ROOT)}")
        for line in report.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Compiling", "warning")):
                log(f"ptxas: {line.strip()}")
    C, R = 256, 64
    k1 = load_kernel("spmm_accel", spmm_accel._declare_k1)
    for kern, lib, prefix, f_tiles in (
            ("K1", k1, "spmm_block_slabs", K1_SWEEP),
            ("K2", load_kernel("spmm_windowed", spmm_accel._declare_k2),
             "spmm_windowed", (128,)),
            ("K3", load_kernel("spmm_hbm", spmm_hbm._declare), "spmm_hbm",
             (128,))):
        for f_tile in f_tiles:
            smem = getattr(lib, f"{prefix}_smem_bytes")(C, R, f_tile)
            ctas = {inst: getattr(lib, f"{prefix}_ctas_per_sm")(
                        C, R, f_tile, int(inst == "bulk"))
                    for inst in spmm_accel.GATHER_INSTANCES}
            log(f"{kern} at C={C}, R={R}, f_tile={f_tile}: {smem} B of "
                f"dynamic shared memory per CTA (no [R, f_tile] tile); CTAs "
                f"per SM: " + ", ".join(f"{i} {n}" for i, n in ctas.items()))
            if min(ctas.values()) <= 2:
                raise AssertionError(f"{kern} f_tile={f_tile}: {ctas} CTAs "
                                     f"per SM")
    # every slab shape the partition tuner can promote (phase 13), at
    # R = C, the most rows a block of C slots holds
    libs = {"K1": (k1, "spmm_block_slabs", spmm_accel.K1_F_TILE),
            "K2": (load_kernel("spmm_windowed", spmm_accel._declare_k2),
                   "spmm_windowed", spmm_accel.DEFAULT_F_TILE),
            "K3": (load_kernel("spmm_hbm", spmm_hbm._declare), "spmm_hbm",
                   spmm_hbm.DEFAULT_F_TILE)}
    for base, cand in candidate_shapes():
        C = cand.config.deg_bound
        shapes = []
        for kern, (lib, prefix, f_tile) in libs.items():
            smem = getattr(lib, f"{prefix}_smem_bytes")(C, C, f_tile)
            ctas = {inst: getattr(lib, f"{prefix}_ctas_per_sm")(
                        C, C, f_tile, int(inst == "bulk"))
                    for inst in spmm_accel.GATHER_INSTANCES}
            shapes.append(f"{kern} f_tile {f_tile} {smem} B, CTAs per SM "
                          + "/".join(str(v) for v in ctas.values()))
            if min(ctas.values()) <= 2:
                raise AssertionError(f"{kern} at candidate {cand.label} "
                                     f"(C={C}): {ctas} CTAs per SM")
        log(f"candidate {base.mode}({base.max_block_warps},"
            f"{base.max_warp_nzs}) {cand.label}, C={C}, R<={C}: "
            + "; ".join(shapes) + " (bulk/cp_async)")
    log("K4: its source's fixed ring (kSmemBytes, 197,696 B) allows one "
        "CTA per SM")


def edge_case_graph(C, seed):
    """Integer-valued square CSR with zero-degree rows, rows of degree C
    (== deg_bound), C + 1 and 3C + 7 (split), and many small rows."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph
    rng = np.random.default_rng(seed)
    deg = np.concatenate([[0] * 5, [C] * 3, [C + 1] * 2, [3 * C + 7],
                          rng.integers(1, 40, 300), [0] * 3])
    rng.shuffle(deg)
    n = len(deg)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=rowptr[1:])
    colidx = rng.integers(0, n, int(rowptr[-1])).astype(np.int64)
    values = rng.integers(1, 4, int(rowptr[-1])).astype(np.float32)
    return CSRGraph(rowptr, colidx, values, n)


def k1_tiles():
    """Every f_tile K1's wrapper can pick: each multiple of 32 up to
    ``K1_F_TILE``."""
    from repro_torch.kernels.spmm_accel import K1_F_TILE
    return list(range(32, K1_F_TILE + 1, 32))


def k1_c_launch(torch, instance, f_tile, colidx, values, rowloc, out_row,
                x, n_rows):
    """K1 through its C interface in the given gather instance, on the
    current stream. Not counted: only the wrapper counts launches."""
    from repro_torch.kernels import spmm_accel
    from repro_torch.kernels.build import load_kernel
    lib = load_kernel("spmm_accel", spmm_accel._declare_k1)
    B, C = colidx.shape
    R = out_row.shape[1]
    F = x.shape[1]
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    if B == 0 or F == 0 or n_rows == 0:
        return out
    ptrs = (colidx.data_ptr(), values.data_ptr(), rowloc.data_ptr(),
            out_row.data_ptr(), x.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.spmm_block_slabs_launch(*ptrs, B, C, R, F, n_rows, f_tile,
                                      int(instance == "bulk"), stream)
    if err:
        raise RuntimeError(f"K1 {instance} launch failed: "
                           f"{lib.slab_kernel_error_string(err).decode()}")
    return out


def kernel_variants(torch, n_x):
    """(kernel, label, launch, plain version, extra summation levels) for
    a feature operand of n_x rows: K1 at every f_tile its wrapper can pick,
    K3, and K2 at 1, 2 and 4 windows."""
    from functools import partial
    from repro_torch.kernels.spmm_accel import (
        spmm_block_slabs, spmm_block_slabs_plain, spmm_block_slabs_windowed,
        spmm_block_slabs_windowed_plain)
    from repro_torch.kernels.spmm_hbm import (spmm_block_slabs_hbm,
                                              spmm_block_slabs_hbm_plain)
    out = [("K1", f"K1 f_tile={t}", partial(spmm_block_slabs, f_tile=t),
            spmm_block_slabs_plain, 0) for t in k1_tiles()]
    out.append(("K3", "K3", spmm_block_slabs_hbm, spmm_block_slabs_hbm_plain,
                0))
    for nw in (1, 2, 4):
        window = -(-n_x // nw)
        if -(-n_x // window) != nw:
            raise AssertionError(f"{n_x} rows do not split into {nw} windows")

        def k2(*args, window=window):
            return spmm_block_slabs_windowed(*args, window_rows=window)

        def k2_plain(*args, window=window):
            return spmm_block_slabs_windowed_plain(*args, window)
        out.append(("K2", f"K2 {nw} window(s) of {window}", k2, k2_plain,
                    nw))
    return out


def windows_cutting_blocks(torch, slabs, window):
    """Blocks whose live slots fall in more than one row window."""
    live = slabs["values"] != 0
    w = slabs["colidx"].long() // window
    lo = w.masked_fill(~live, 1 << 40).min(dim=1).values
    hi = w.masked_fill(~live, -1).max(dim=1).values
    return int((live.any(dim=1) & (lo != hi)).sum())


def order_pinning_case(torch, dev, F):
    """One block whose single row sums +1 (window 1), +2**24 (window 0) and
    -2**24 (window 1), each times x = 1, with 4-row windows over 8 rows.
    Window partials added in window order give exactly 1; the slots summed
    in slot order give 0. Returns the kernel arguments and the window."""
    colidx = torch.tensor([[5, 1, 6, 0]], dtype=torch.int32, device=dev)
    values = torch.tensor([[1.0, 2.0 ** 24, -2.0 ** 24, 0.0]], device=dev)
    rowloc = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    out_row = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    return (colidx, values, rowloc, out_row,
            torch.ones((8, F), device=dev), 1), 4


def phase_kernel_cases(torch, dev):
    """K1, K2 and K3 against their plain versions on ``dev``; returns each
    kernel's max abs error over the float cases."""
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.kernels.spmm_accel import (
        spmm_block_slabs, spmm_block_slabs_plain, spmm_block_slabs_windowed,
        spmm_block_slabs_windowed_plain)
    from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    n_cases = 0

    def run(label, slabs, n_rows, x, exact, k=None):
        nonlocal n_cases
        args = (slabs["colidx"], slabs["values"], slabs["rowloc"],
                slabs["out_row"])
        mag = None
        for kern, name, fn, plain, levels in kernel_variants(torch,
                                                            x.shape[0]):
            got = fn(*args, x, n_rows)
            want = plain(*args, x, n_rows)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if exact:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{label}: {name} differs from its plain version on "
                        f"an integer-valued graph")
            else:
                if mag is None:
                    mag = spmm_block_slabs_plain(
                        args[0], args[1].abs(), args[2], args[3], x.abs(),
                        n_rows).double()
                kt = torch.as_tensor(k + levels, dtype=torch.float64,
                                     device=x.device)[:, None]
                worst[kern] = max(worst[kern], check_close(
                    f"{label} {name}", got, want, 2 * U * kt * mag))
            n_cases += 1

    configs = {"tpu": PartitionConfig("tpu", 64, 4),
               "paper": PartitionConfig("paper", 12, 32)}
    int_plans = []
    for mode, cfg in configs.items():
        g_int = edge_case_graph(cfg.deg_bound, seed=len(int_plans))
        g_norm = gcn_normalize(make_power_law_graph(3000, 60000, seed=3))
        p_int = build_partition_plan(g_int, cfg, device=dev)
        p_norm = build_partition_plan(g_norm, cfg, device=dev)
        int_plans.append((p_int, g_int))
        split = int(p_int.partition.is_split.sum())
        if split == 0:
            raise AssertionError(f"{mode}: edge-case graph has no split rows")
        cut = {nw: (windows_cutting_blocks(torch, p_int.slabs,
                                           -(-g_int.n_cols // nw)),
                    windows_cutting_blocks(torch, p_norm.slabs,
                                           -(-g_norm.n_cols // nw)))
               for nw in (2, 4)}
        if any(min(c) == 0 for c in cut.values()):
            raise AssertionError(f"{mode}: no window boundary cuts a block")
        for F in (1, 100, 2048):
            xi = torch.randint(-4, 5, (g_int.n_cols, F), generator=gen,
                               device=dev).float()
            run(f"{mode} int F={F}", p_int.slabs, g_int.n_rows, xi, True)
            xf = torch.randn((g_norm.n_cols, F), generator=gen, device=dev)
            run(f"{mode} normalized F={F}", p_norm.slabs, g_norm.n_rows, xf,
                False, summation_k(g_norm, cfg.deg_bound, True))
        log(f"K1, K2, K3 == plain: {mode} mode C={cfg.deg_bound} "
            f"R={p_int.slabs['R']}, {p_int.num_blocks} blocks ({split} "
            f"split); blocks cut by a window boundary (int, normalized): "
            f"{cut[2]} at 2 windows, {cut[4]} at 4")

    # merged slabs of both modes (C and R padded to the batch max) plus a
    # tail of all-zero padding blocks
    plans = [p for p, _ in int_plans]
    b_total = sum(p.num_blocks for p in plans)
    merged, _, _, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans],
        [g.n_cols for _, g in int_plans],
        pad_blocks_to=bucket_blocks(b_total) * 2)
    n_x = sum(g.n_cols for _, g in int_plans)
    for F in (1, 100, 2048):
        xi = torch.randint(-4, 5, (n_x, F), generator=gen, device=dev).float()
        run(f"merged F={F}", merged, n_out, xi, True)
    # a view 4 bytes past a 16-byte boundary: K1, K2 and K3 take cp_async
    xu = torch.empty(n_x * 2048 + 1, device=dev)[1:].view(n_x, 2048)
    xu.copy_(xi)
    run("merged F=2048, unaligned x", merged, n_out, xu, True)
    log(f"K1, K2, K3 == plain: merged C={merged['C']} R={merged['R']}, "
        f"{b_total} live + {merged['colidx'].shape[0] - b_total} padding "
        f"blocks")
    for F in (1, 100, 2048):
        pin, window = order_pinning_case(torch, dev, F)
        got = spmm_block_slabs_windowed(*pin, window_rows=window).cpu()
        want = spmm_block_slabs_windowed_plain(
            *[a.cpu() if torch.is_tensor(a) else a for a in pin], window)
        if not (torch.equal(got, want) and bool((want == 1.0).all())):
            raise AssertionError(f"K2 order pinning F={F}: got "
                                 f"{got[0, :4].tolist()}, plain on the CPU "
                                 f"{want[0, :4].tolist()} (window order: 1)")
    by_instance = {k: dict(fn.launches_by_instance) for k, fn in
                   (("K1", spmm_block_slabs),
                    ("K2", spmm_block_slabs_windowed),
                    ("K3", spmm_block_slabs_hbm))}
    log(f"K2 window order pinned (exactly 1.0 at F=1, 100, 2048); gather "
        f"instances launched: {by_instance}")
    if dev.type == "cuda" and min(n for c in by_instance.values()
                                  for n in c.values()) < 1:
        raise AssertionError(f"a gather instance never ran: {by_instance}")
    log(f"phase 3 ok: {n_cases} cases, integer cases exact, float max "
        f"|kernel - plain|: " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in worst.items()))
    return worst


def csr_oracle(torch, g, x, nnz_chunk, magnitude=False):
    """A'.x in fp64 by the plain CSR product on ``x``'s device (exact for
    small integer values); with ``magnitude``, |A'|.|x|, the scale of the
    summation bounds. The one oracle of the GCN phases."""
    import numpy as np
    from repro_torch.kernels.ref import csr_spmm_ref
    vals = g.values.astype(np.float64)
    if magnitude:
        vals, x = np.abs(vals), x.abs()
    return csr_spmm_ref(g.rowptr, g.colidx, vals, x.double(),
                        nnz_chunk=nnz_chunk)


def csr_check(torch, g, x, y, C, nnz_chunk, extra_levels=0):
    """Hold ``y`` (original row order) against the fp64 CSR oracle for A'.x,
    within the summation bound of the kernel's fp32 sums (``extra_levels``:
    K2's window partials)."""
    want = csr_oracle(torch, g, x, nnz_chunk)
    mag = csr_oracle(torch, g, x, nnz_chunk, magnitude=True)
    k = torch.as_tensor(summation_k(g, C, False) + extra_levels,
                        dtype=torch.float64, device=x.device)[:, None]
    return check_close("served", y, want, U * k * mag)


def phase_serve(torch, dev):
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_benchmark_graph
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs)
    from repro_torch.models.layers import dense_init
    from repro_torch.serve.graph_engine import GraphRequest, GraphServeEngine

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    graphs = {}
    for i, name in enumerate(GRAPHS):
        t0 = time.perf_counter()
        g, scale = make_benchmark_graph(name, seed=i)
        graphs[name] = gcn_normalize(g)
        log(f"{name}: {g.n_rows} nodes, {graphs[name].nnz} nnz after "
            f"gcn_normalize (edge scale {scale}), built in "
            f"{time.perf_counter() - t0:.1f}s")
    engine = GraphServeEngine(device=dev, backend="accel",
                              max_graphs_per_batch=2)
    for name, g in graphs.items():
        t0 = time.perf_counter()
        plan = engine.register_graph(name, g)
        bp = plan.partition
        log(f"{name}: plan {plan.num_blocks} blocks "
            f"({int(bp.is_split.sum())} split), C={plan.slabs['C']} "
            f"R={plan.slabs['R']}, built in {time.perf_counter() - t0:.1f}s")

    gen = torch.Generator().manual_seed(0)
    dims = DIMS + [N_CLASSES]
    weights = [dense_init(gen, a, b, torch.float32, device=dev)
               for a, b in zip(dims[:-1], dims[1:])]
    dgen = torch.Generator(device=dev).manual_seed(1)
    feats = {name: torch.randn((g.n_rows, dims[0]), generator=dgen,
                               device=dev) for name, g in graphs.items()}
    nnz_chunk = 1 << 17
    C = engine.config.deg_bound

    spmm_block_slabs.launches = 0          # main path starts here
    spmm_block_slabs.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    t_main = time.perf_counter()
    last_xw = {}
    for rnd in range(2):
        h = dict(feats)
        for li, w in enumerate(weights):
            xw = {name: h[name] @ w for name in graphs}
            reqs = engine.serve([GraphRequest(name, xw[name])
                                 for name in graphs])
            errs = []
            for r in reqs:
                errs.append(csr_check(torch, graphs[r.graph_id],
                                      xw[r.graph_id], r.out, C, nnz_chunk))
                h[r.graph_id] = (torch.relu(r.out) if li < len(weights) - 1
                                 else r.out)
            lat = ", ".join(f"{r.graph_id} {r.latency_s * 1e3:.1f}ms"
                            for r in reqs)
            log(f"round {rnd} layer {li} F={w.shape[1]}: max err "
                f"{max(errs):.2e}; latency {lat}")
            last_xw = xw
        for name in graphs:
            if not bool(torch.isfinite(h[name]).all()) or \
                    tuple(h[name].shape) != (graphs[name].n_rows, N_CLASSES):
                raise AssertionError(f"{name}: logits not finite or of shape "
                                     f"{tuple(h[name].shape)}")

    # concurrent submitters at the last layer's width (256)
    n_threads, per_thread = 4, 4
    futs = [[None] * per_thread for _ in range(n_threads)]
    latencies = []          # submit -> answer, one per request
    all_answered = threading.Event()
    lat_lock = threading.Lock()

    def record(t0):
        with lat_lock:
            latencies.append(time.perf_counter() - t0)
            if len(latencies) == n_threads * per_thread:
                all_answered.set()

    def caller(t):
        for k in range(per_thread):
            name = GRAPHS[(t + k) % len(GRAPHS)]
            t_submit = time.perf_counter()
            fut = engine.submit(name, last_xw[name] * (t + 1.0))
            fut.add_done_callback(lambda _f, t0=t_submit: record(t0))
            futs[t][k] = (name, t + 1.0, fut)

    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a submitter thread did not finish")
    errs = []
    for row in futs:
        for name, scalef, fut in row:
            got = fut.result(timeout=600)
            errs.append(csr_check(torch, graphs[name], last_xw[name] * scalef,
                                  got, C, nnz_chunk))
    if not all_answered.wait(timeout=600):
        raise AssertionError("not every concurrent request was answered")
    t_main = time.perf_counter() - t_main
    launches = spmm_block_slabs.launches   # main path ends here
    by_instance = dict(spmm_block_slabs.launches_by_instance)
    st = engine.stats()
    engine.close()
    log(f"concurrent: {n_threads} threads x {per_thread} submits, max err "
        f"{max(errs):.2e}, sched p50 {st['sched_p50_latency_s'] * 1e3:.1f}ms "
        f"p99 {st['sched_p99_latency_s'] * 1e3:.1f}ms; request latencies "
        f"(ms): {', '.join(f'{v * 1e3:.1f}' for v in sorted(latencies))}")
    log(f"stats: dispatches={st['batches_dispatched']} "
        f"routed_resident={st['routed_resident']} "
        f"graphs_per_dispatch={st['graphs_per_dispatch']:.2f} "
        f"requests_per_batch={st['requests_per_batch']:.2f} "
        f"cache builds={st['cache_builds']} hits={st['cache_hits']} "
        f"block_pad_ratio={st['block_pad_ratio']:.3f} "
        f"avg_dispatch={st['avg_dispatch_s'] * 1e3:.1f}ms")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured")
    log(f"K1 launches on the main path: {launches} "
        f"(dispatches {st['batches_dispatched']}); main path "
        f"{t_main:.1f}s including the oracle checks; peak device memory "
        f"{peak}")
    if launches <= 0 or launches != st["batches_dispatched"] \
            or launches != st["routed_resident"]:
        raise AssertionError(f"K1 launches {launches} != dispatches "
                             f"{st['batches_dispatched']}")
    # every fused X is a fresh contiguous tensor of width % 4 == 0
    log(f"K1 launches by gather instance: {by_instance}")
    if by_instance != {"bulk": launches, "cp_async": 0}:
        raise AssertionError(f"K1's launches by instance {by_instance}: "
                             f"expected all {launches} bulk")
    return graphs, engine, launches


def phase_profile(torch, engine, graphs):
    """Where one served F=2048 layer spends its device time: the two dense
    products and the fused dispatch, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.graph_engine import GraphRequest
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((2048, 2048), generator=gen, device=dev) / 2048 ** 0.5
    h = {name: torch.randn((g.n_rows, 2048), generator=gen, device=dev)
         for name, g in graphs.items()}

    def layer():
        engine.serve([GraphRequest(name, h[name] @ w) for name in graphs])
        torch.cuda.synchronize()

    layer()                                     # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        layer()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        layer()
    rows = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log("profile: the profiler recorded no device time; not measured")
        return
    log(f"profile of one served F=2048 layer (both graphs): wall "
        f"{wall_ms:.1f} ms (median of 3, unprofiled), device kernels "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms * 100:.1f}% busy)")
    for ms, count, key in rows[:8]:
        log(f"profile:   {ms:9.3f} ms  {ms / busy_ms * 100:5.1f}%  x{count:<3d} "
            f"{key[:70]}")


def phase_routed(torch, dev, graphs, cache):
    """Slice B1's main path: GraphServeEngine(backend="auto") routing each
    fused dispatch to K1, K2 or K3. Returns the small graphs, the engine
    that served them and the launch count of each kernel."""
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.kernels.router import VmemBudgetError
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs,
                                                spmm_block_slabs_windowed)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    from repro_torch.models.layers import dense_init
    from repro_torch.serve.graph_engine import GraphRequest, GraphServeEngine

    small = {}
    for name, n, e in PRESET_GRAPHS:
        small[name] = gcn_normalize(make_power_law_graph(n, e, seed=0))
    # the large graphs fuse into one dispatch; each small graph dispatches
    # alone, so fusing cannot move it to another regime
    big_engine = GraphServeEngine(device=dev, backend="auto", cache=cache,
                                  max_graphs_per_batch=2)
    small_engine = GraphServeEngine(device=dev, backend="auto",
                                    max_graphs_per_batch=1)
    for name, g in graphs.items():
        big_engine.register_graph(name, g)
    for name, g in small.items():
        plan = small_engine.register_graph(name, g)
        log(f"{name} preset graph: {g.n_rows} nodes, {g.nnz} nnz after "
            f"gcn_normalize, {plan.num_blocks} blocks "
            f"({int(plan.partition.is_split.sum())} split)")
    every = dict(graphs, **small)
    expect = {name: "hbm" for name in graphs}
    expect.update({"25m": "windowed", "tiny": "resident"})

    gen = torch.Generator().manual_seed(0)
    dims = DIMS + [N_CLASSES]
    weights = [dense_init(gen, a, b, torch.float32, device=dev)
               for a, b in zip(dims[:-1], dims[1:])]
    dgen = torch.Generator(device=dev).manual_seed(5)
    feats = {name: torch.randn((g.n_rows, dims[0]), generator=dgen,
                               device=dev) for name, g in every.items()}
    nnz_chunk = 1 << 17
    C = big_engine.config.deg_bound
    kernels = {"K1": spmm_block_slabs, "K2": spmm_block_slabs_windowed,
               "K3": spmm_block_slabs_hbm}

    for fn in kernels.values():            # main path starts here
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    t_main = time.perf_counter()
    for rnd in range(2):
        h = dict(feats)
        for li, w in enumerate(weights):
            xw = {name: h[name] @ w for name in every}
            served = big_engine.serve([GraphRequest(name, xw[name])
                                       for name in graphs])
            decisions = {name: big_engine.last_decision for name in graphs}
            for name in small:
                served += small_engine.serve([GraphRequest(name, xw[name])])
                decisions[name] = small_engine.last_decision
            errs = []
            for r in served:
                d = decisions[r.graph_id]
                if d.backend != expect[r.graph_id]:
                    raise AssertionError(f"{r.graph_id} routed to "
                                         f"{d.backend}: {d.describe()}")
                extra = d.num_windows if d.backend == "windowed" else 0
                errs.append(csr_check(torch, every[r.graph_id],
                                      xw[r.graph_id], r.out, C, nnz_chunk,
                                      extra))
                h[r.graph_id] = (torch.relu(r.out) if li < len(weights) - 1
                                 else r.out)
            if rnd == 0 and li == 0:
                for name in ("Reddit", "25m", "tiny"):
                    log(f"route {name}: {decisions[name].describe()}")
            log(f"routed round {rnd} layer {li} F={w.shape[1]}: max err "
                f"{max(errs):.2e}; latency "
                + ", ".join(f"{r.graph_id} {r.latency_s * 1e3:.1f}ms"
                            for r in served))
        for name, g in every.items():
            if not bool(torch.isfinite(h[name]).all()) or \
                    tuple(h[name].shape) != (g.n_rows, N_CLASSES):
                raise AssertionError(f"{name}: logits not finite or of shape "
                                     f"{tuple(h[name].shape)}")
    t_main = time.perf_counter() - t_main
    launches = {k: fn.launches for k, fn in kernels.items()}  # path ends
    by_instance = {k: dict(fn.launches_by_instance)
                   for k, fn in kernels.items()}
    big, sm = big_engine.stats(), small_engine.stats()
    routed = {"K1": big["routed_resident"] + sm["routed_resident"],
              "K2": big["routed_windowed"] + sm["routed_windowed"],
              "K3": big["routed_hbm"] + sm["routed_hbm"]}
    log(f"routed path: launches {launches}, engines' routed counts "
        f"{routed}; dispatches {big['batches_dispatched']} + "
        f"{sm['batches_dispatched']}; {t_main:.1f}s including the oracle "
        f"checks")
    if launches != routed or min(launches.values()) < 1:
        raise AssertionError(f"kernel launches {launches} differ from the "
                             f"routed dispatches {routed}")
    # every routed X is a fresh contiguous product of width % 4 == 0, so
    # every K1, K2 and K3 launch of the path must be bulk
    log(f"routed path: launches by gather instance {by_instance}")
    for k, counts in by_instance.items():
        if counts != {"bulk": launches[k], "cp_async": 0}:
            raise AssertionError(f"{k}'s routed launches by instance "
                                 f"{counts}: expected all {launches[k]} "
                                 f"bulk")
    big_engine.close()

    forced = GraphServeEngine(device=dev, backend="pallas", cache=cache)
    forced.register_graph("Reddit", graphs["Reddit"])
    try:
        forced.serve_one("Reddit", feats["Reddit"][:, :8].contiguous())
    except VmemBudgetError as e:
        log(f"backend='pallas' on Reddit raised VmemBudgetError: "
            f"{str(e)[:120]}...")
    else:
        raise AssertionError("backend='pallas' on Reddit did not raise "
                             "VmemBudgetError")
    finally:
        forced.close()
    return small, small_engine, launches


def sparse_csr(torch, graphs, col_offsets, n_out, n_x, dev):
    """torch.sparse CSR tensor of the block-diagonal A of ``graphs`` (a
    yardstick only, never on the port's path)."""
    import numpy as np
    rowptrs, cols, vals = [np.zeros(1, np.int64)], [], []
    for g, c0 in zip(graphs, col_offsets):
        rowptrs.append(g.rowptr[1:] + rowptrs[-1][-1])
        cols.append(g.colidx + c0)
        vals.append(g.values)
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.concatenate(rowptrs)).to(dev),
        torch.from_numpy(np.concatenate(cols)).to(dev),
        torch.from_numpy(np.concatenate(vals)).to(dev), size=(n_out, n_x))


def bound_of(n_x, n_out, F, slabs, nnz):
    """The least time the card could take, from bytes and operations."""
    slab_bytes = sum(slabs[k].numel() * 4
                     for k in ("colidx", "values", "rowloc", "out_row"))
    moved = (n_x + n_out) * F * 4 + slab_bytes
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * nnz * F / FP32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", moved, bytes_ms,
            ops_ms)


def phase_timing_k2(torch, small, engine, launches, float_err):
    """K2 on the 25m preset's graph at F=2048 (2 windows), against its plain
    version, the library SpMM and the memory bound; K3 on the same slabs
    (one window: no sort) shows what K2's window order costs."""
    from repro_torch.kernels.router import route_spmm
    from repro_torch.kernels.spmm_accel import (spmm_block_slabs_plain,
                                                spmm_block_slabs_windowed,
                                                spmm_block_slabs_windowed_plain)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    dev = torch.device("cuda")
    F = 2048
    g = small["25m"]
    plan = engine.plan_for("25m")
    s = plan.slabs
    d = route_spmm(g.n_cols, F, int(s["C"]), int(s["R"]))
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((g.n_cols, F), generator=gen, device=dev)
    args = (s["colidx"], s["values"], s["rowloc"], s["out_row"], x,
            plan.n_rows)
    k2 = lambda: spmm_block_slabs_windowed(*args)     # noqa: E731
    plain = lambda: spmm_block_slabs_windowed_plain(  # noqa: E731
        *args, d.window_rows)
    got, want = k2(), plain()
    mag = spmm_block_slabs_plain(args[0], args[1].abs(), args[2], args[3],
                                 x.abs(), plan.n_rows).double()
    k = summation_k(g, int(s["C"]), True) + d.num_windows
    kt = torch.as_tensor(k, dtype=torch.float64, device=dev)[:, None]
    err = check_close("25m F=2048 K2 vs plain", got, want, 2 * U * kt * mag)
    del mag, want
    a_csr = sparse_csr(torch, [g], [0], plan.n_rows, g.n_cols, dev)
    lib = lambda: torch.sparse.mm(a_csr, x)           # noqa: E731
    lib_err = float((got[plan.inv_perm] - lib()).abs().max())
    k2()
    lib()
    ms = cuda_ms(k2, 10)                 # K2 and sparse.mm in turns
    library_ms = cuda_ms(lib, 10)
    ms_again = cuda_ms(k2, 10)
    plain_ms = cuda_ms(plain, 3)
    k3 = lambda: spmm_block_slabs_hbm(*args)          # noqa: E731
    k3()
    k3_ms = cuda_ms(k3, 10)
    bound_ms, bound_by, moved, bytes_ms, ops_ms = bound_of(
        g.n_cols, plan.n_rows, F, s, g.nnz)
    log(f"K2 25m graph F={F}: {plan.num_blocks} blocks, {d.num_windows} "
        f"windows of {d.window_rows}, n={g.n_rows} nnz={g.nnz}; K2 "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.sparse.mm "
        f"{library_ms:.3f} ms (max |K2 - sparse.mm| {lib_err:.2e}); bound "
        f"{bound_ms:.3f} ms ({moved / 1e9:.4f} GB, {bytes_ms:.3f} ms; "
        f"{2.0 * g.nnz * F / 1e9:.2f} GFLOP, {ops_ms:.3f} ms)")
    log(f"K2 25m graph F={F}, needed gather {g.nnz * F * 4 / 1e9:.3f} GB: "
        + "; ".join(f"{name} {t:.3f} ms, gather "
                    f"{gather_rate(g.nnz, F, t):.2f} TB/s, "
                    f"{bound_ms / t * 100:.2f}% of the bound"
                    for name, t in (("K2", ms), ("torch.sparse.mm",
                                                 library_ms),
                                    ("K2 again", ms_again),
                                    ("K3 on the same slabs", k3_ms))))
    return {"name": "spmm_block_slabs_windowed", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm_windowed.cu",
            "replaces": "src/repro/kernels/spmm_accel.py:180",
            "launches": launches["K2"], "max_abs_err": max(err, float_err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def gather_rate(nnz, F, ms):
    """TB/s of the gather a slab SpMM needs: one F-wide fp32 row segment
    per non-zero (nnz * F * 4 bytes), whatever L2 serves of it."""
    return nnz * F * 4 / (ms * 1e-3) / 1e12


def fused_dispatch(torch, plans, F):
    """The engine's fused dispatch of ``plans`` (merged slabs padded to the
    block bucket) with random features of width F: (merged slabs, output
    and column offsets, n_out, kernel arguments)."""
    from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks
    merged, out_off, col_off, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans],
        [p.n_cols for p in plans],
        pad_blocks_to=bucket_blocks(sum(p.num_blocks for p in plans)))
    dev = merged["colidx"].device
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((int(col_off[-1]), F), generator=gen, device=dev)
    return merged, out_off, col_off, n_out, (
        merged["colidx"], merged["values"], merged["rowloc"],
        merged["out_row"], x, n_out)


def k1_sweep_configs(torch, args):
    """K1 in each gather instance at each f_tile of ``K1_SWEEP``, through
    the C interface on ``args``."""
    from functools import partial
    from repro_torch.kernels.spmm_accel import GATHER_INSTANCES
    return {f"K1 {inst} f_tile={t}": partial(k1_c_launch, torch, inst, t,
                                             *args)
            for t in K1_SWEEP for inst in GATHER_INSTANCES}


def timed_in_turns(fns, reps, timer, rounds=2):
    """Each callable timed ``rounds`` times, in turns: ms per call."""
    ms = {label: [] for label in fns}
    for _ in range(rounds):
        for label, fn in fns.items():
            fn()
            ms[label].append(timer(fn, reps))
    return ms


def phase_timing(torch, graphs, engine, launches, float_err):
    """K1 and K3 at the fused F=2048 Reddit+Arxiv dispatch shape against
    their plain version (the same function), the library SpMM and the
    memory bound, timed in turns on one card: K1, K3, K1 again, the plain
    version, torch.sparse.mm; then K1's column-slice sweep (each f_tile of
    ``K1_SWEEP`` in both gather instances) in turns with K3 and
    torch.sparse.mm, each checked against the plain version first.
    ``launches`` and ``float_err`` are per kernel. Returns the two kernel
    records."""
    import numpy as np
    from repro_torch.kernels.spmm_accel import (K1_F_TILE, spmm_block_slabs,
                                                spmm_block_slabs_plain)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm

    dev = torch.device("cuda")
    F = 2048
    plans = [engine.plan_for(name) for name in graphs]
    b_live = sum(p.num_blocks for p in plans)
    merged, out_off, col_off, n_out, args = fused_dispatch(torch, plans, F)
    n_x = int(col_off[-1])
    x = args[4]

    k1 = lambda: spmm_block_slabs(*args)               # noqa: E731
    k3 = lambda: spmm_block_slabs_hbm(*args)           # noqa: E731
    plain = lambda: spmm_block_slabs_plain(*args)      # noqa: E731
    want = plain()
    k = np.concatenate([summation_k(g, int(merged["C"]), True)
                        for g in graphs.values()])
    bound = pair_bound(torch, spmm_block_slabs_plain, args[:4], x, n_out, k)
    got = k1()
    err = {"K1": check_close("fused F=2048 K1 vs plain", got, want, bound)}
    got3 = k3()
    err["K3"] = check_close("fused F=2048 K3 vs plain", got3, want, bound)
    del got3
    sweep_fns = k1_sweep_configs(torch, args)
    sweep_err = {label: check_close(f"fused F=2048 {label} vs plain", fn(),
                                    want, bound)
                 for label, fn in sweep_fns.items()}
    del bound, want
    log("fused F=2048 sweep configs within the pair bound of plain, max "
        "|err|: " + ", ".join(f"{k} {v:.2e}" for k, v in sweep_err.items()))
    a_csr = sparse_csr(torch, graphs.values(), col_off, n_out, n_x, dev)
    lib = lambda: torch.sparse.mm(a_csr, x)            # noqa: E731
    lib_out = lib()
    perm_back = torch.cat([p.inv_perm + int(o) for p, o in
                           zip(plans, out_off[:-1])])
    lib_err = float((got[perm_back] - lib_out).abs().max())
    del lib_out
    for _ in range(2):
        k1()
        k3()
    lib()
    ms = {"K1": cuda_ms(k1, 10), "K3": cuda_ms(k3, 10)}
    ms["K1 again"] = cuda_ms(k1, 10)     # K1 and K3 in turns, one card
    plain_ms = cuda_ms(plain, 2)
    library_ms = cuda_ms(lib, 5)
    zero_ms = cuda_ms(lambda: torch.zeros((n_out, F), device=dev), 10)

    nnz = sum(g.nnz for g in graphs.values())
    bound_ms, bound_by, moved, bytes_ms, ops_ms = bound_of(
        n_x, n_out, F, merged, nnz)
    slab_pass = sum(merged[k].numel() * 4
                    for k in ("colidx", "values", "rowloc", "out_row"))
    turns = dict(sweep_fns, **{"K3": k3, "torch.sparse.mm": lib})
    sweep = timed_in_turns(turns, 5, cuda_ms)
    log(f"K1 column-slice sweep, fused dispatch F={F}, in turns (2 rounds "
        f"of 5 calls; ms per call; X slice = n_x x f_tile x 4 B, L2 50 MB; "
        f"slabs read once per slice, {slab_pass / 1e6:.1f} MB a pass):")
    for label, ts in sweep.items():
        f_tile = int(label.rsplit("=", 1)[1]) if "f_tile=" in label else None
        extra = (f"; X slice {n_x * f_tile * 4 / 1e6:.1f} MB, slabs "
                 f"{-(-F // f_tile) * slab_pass / 1e9:.2f} GB"
                 if f_tile else "")
        log(f"sweep {label}: {ts[0]:.3f} / {ts[1]:.3f} ms, gather "
            f"{gather_rate(nnz, F, min(ts)):.2f} TB/s, "
            f"{bound_ms / min(ts) * 100:.2f}% of the bound{extra}")
    log(f"K1 at f_tile={K1_F_TILE} (the default at F={F}) {ms['K1']:.3f} ms; "
        f"of which zero-filling the output alone takes {zero_ms:.3f} ms")

    # hub row alone: the split blocks of Reddit's largest row, all adding
    # into one output row
    reddit = plans[0]
    bp = reddit.partition
    hub_row = int(bp.meta[bp.is_split][np.argmax(bp.meta[bp.is_split, 0]), 2])
    hub = np.flatnonzero(bp.is_split & (bp.meta[:, 2] == hub_row))
    hsl = {k: reddit.slabs[k][torch.from_numpy(hub).to(dev)].contiguous()
           for k in ("colidx", "values", "rowloc", "out_row")}
    hx = x[:reddit.n_cols]
    hub_args = (hsl["colidx"], hsl["values"], hsl["rowloc"], hsl["out_row"],
                hx, reddit.n_rows)
    spmm_block_slabs(*hub_args)
    hub_ms = cuda_ms(lambda: spmm_block_slabs(*hub_args), 10)
    # control: the same blocks, each writing a row of its own (no atomic
    # contention), isolates what the shared hub row costs
    spread = torch.full_like(hsl["out_row"], len(hub))
    spread[:, 0] = torch.arange(len(hub), device=dev, dtype=torch.int32)
    spread_args = hub_args[:3] + (spread, hx, len(hub))
    spmm_block_slabs(*spread_args)
    spread_ms = cuda_ms(lambda: spmm_block_slabs(*spread_args), 10)
    hub_bytes = len(hub) * reddit.slabs["C"] * F * 4
    log(f"hub row: {len(hub)} split blocks into one row at F={F}: K1 "
        f"{hub_ms:.3f} ms; the same blocks into {len(hub)} distinct rows "
        f"{spread_ms:.3f} ms (gathering the {len(hub) * reddit.slabs['C']} "
        f"slots without reuse would take {hub_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms at the memory rate)")

    log(f"fused dispatch F={F}: {merged['colidx'].shape[0]} blocks "
        f"({b_live} live), n_x={n_x} n_out={n_out} nnz={nnz}; K1 "
        f"{ms['K1']:.3f} ms (again {ms['K1 again']:.3f}), K3 {ms['K3']:.3f} "
        f"ms, plain {plain_ms:.3f} ms, torch.sparse.mm {library_ms:.3f} ms "
        f"(max |K1 - sparse.mm| {lib_err:.2e}); bound {bound_ms:.3f} ms "
        f"({moved / 1e9:.3f} GB moved, {bytes_ms:.3f} ms; "
        f"{2.0 * nnz * F / 1e9:.1f} GFLOP, {ops_ms:.3f} ms)")
    log(f"fused dispatch F={F}, needed gather {nnz * F * 4 / 1e9:.1f} GB "
        f"(nnz x F x 4): " + "; ".join(
            f"{name} {t:.3f} ms, gather {gather_rate(nnz, F, t):.2f} TB/s, "
            f"{bound_ms / t * 100:.2f}% of the bound"
            for name, t in (("K1", ms["K1"]), ("K3", ms["K3"]),
                            ("K1 again", ms["K1 again"]),
                            ("torch.sparse.mm", library_ms))))
    records = []
    for kern, name, source, replaces in (
            ("K1", "spmm_block_slabs", "src/repro_torch/csrc/spmm_accel.cu",
             "src/repro/kernels/spmm_accel.py:73"),
            ("K3", "spmm_block_slabs_hbm", "src/repro_torch/csrc/spmm_hbm.cu",
             "src/repro/kernels/spmm_hbm.py:48")):
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": max(err[kern], float_err[kern]),
            "ms": ms[kern], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    return records


def device_ms(fn, reps):
    """Like ``cuda_ms``, for calls shorter than their host overhead: the
    card is held busy while the calls are queued, so the events time the
    calls back to back on the card."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)         # ~10 ms of clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing_resident(torch, small, engine):
    """K1 in the regime ``auto`` routes to it (N_pad <= 4096 at fp32, X
    within L2) at F=2048: the ``tiny`` preset's graph and a 4,096-node
    power-law graph, K1 at its default and in the sweep's configurations
    against torch.sparse.mm on the same A and X, in turns."""
    import numpy as np
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.kernels.router import route_spmm
    from repro_torch.kernels.spmm_accel import (spmm_block_slabs,
                                                spmm_block_slabs_plain)
    dev = torch.device("cuda")
    F = 2048
    g4 = gcn_normalize(make_power_law_graph(4096, 32768, seed=6))
    cases = {"tiny": (small["tiny"], engine.plan_for("tiny")),
             "power-law 4096": (g4, build_partition_plan(
                 g4, PartitionConfig(), device=dev))}
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, (g, plan) in cases.items():
        s = plan.slabs
        d = route_spmm(g.n_cols, F, int(s["C"]), int(s["R"]))
        if d.backend != "resident":
            raise AssertionError(f"{name}: routed to {d.backend}")
        x = torch.randn((g.n_cols, F), generator=gen, device=dev)
        args = (s["colidx"], s["values"], s["rowloc"], s["out_row"], x,
                plan.n_rows)
        want = spmm_block_slabs_plain(*args)
        bound = pair_bound(torch, spmm_block_slabs_plain, args[:4], x,
                           plan.n_rows,
                           summation_k(g, int(s["C"]), True))
        fns = {"K1 default": lambda: spmm_block_slabs(*args)}
        fns.update(k1_sweep_configs(torch, args))
        for label, fn in fns.items():
            check_close(f"{name} F={F} {label} vs plain", fn(), want, bound)
        a_csr = sparse_csr(torch, [g], [0], plan.n_rows, g.n_cols, dev)
        fns["torch.sparse.mm"] = lambda: torch.sparse.mm(a_csr, x)
        ms = timed_in_turns(fns, 50, device_ms)
        bound_ms = bound_of(g.n_cols, plan.n_rows, F, s, g.nnz)[0]
        log(f"resident regime, {name}: {g.n_rows} nodes, {g.nnz} nnz, "
            f"{plan.num_blocks} blocks, F={F}, X {g.n_cols * F * 4 / 1e6:.1f}"
            f" MB; bound {bound_ms:.4f} ms; ms per call (2 rounds of 50, "
            f"queued behind a busy card):")
        for label, ts in ms.items():
            log(f"resident {name} {label}: {ts[0]:.4f} / {ts[1]:.4f} ms, "
                f"{bound_ms / min(ts) * 100:.2f}% of the bound")
        del want, bound


# ------------------------------------------------------------ slice D
TRAIN_PRESET = "100m"      # examples/train_gcn.py: 9 layers, ~106M params
TRAIN_STEPS = 5
MUTATE_GRAPH = "Arxiv"
MUTATE_F = 2048
MUTATE_DELTAS = 4          # each of MUTATE_EDGES inserts and deletes
MUTATE_EDGES = 250


def grad_bound_rel(C, layers):
    """Relative bound for a gradient of the same parameters through K1
    against the twin. Each aggregation's two fp32 sums differ from the
    exact one by at most (C + 2) u of ``|A| @ |x|`` per row (C products in
    a block, split partials, the add into zero); the forward and backward
    passes run at most ``2 * layers`` aggregations, each adding at most its
    own relative error, and the pair of paths doubles it. Held per
    parameter against ``max |grad|`` of the twin's."""
    return 2 * 2 * layers * (C + 2) * U


class PlanCount:
    """An aggregation operator that adds K1's launches during each call to
    ``launches``: the launches of one plan (A' or A'^T)."""

    def __init__(self, op):
        self.op, self.launches = op, 0

    def __call__(self, x):
        from repro_torch.kernels.spmm_accel import spmm_block_slabs
        before = spmm_block_slabs.launches
        out = self.op(x)
        self.launches += spmm_block_slabs.launches - before
        return out


def hold_grads(torch, label, got, want, rel):
    """Every gradient within ``rel * max|want|``; returns the largest share
    of the bound used."""
    worst = 0.0
    for i, (pg, pw) in enumerate(zip(got, want)):
        for k in pw:
            scale = float(pw[k].abs().max())
            err = float((pg[k].float() - pw[k].float()).abs().max())
            if err > rel * scale:
                raise AssertionError(f"{label}: layer {i} {k} gradient off "
                                     f"by {err:.3e}, bound {rel * scale:.3e}")
            worst = max(worst, err / (rel * scale) if scale else 0.0)
    return worst


def phase_train(torch, dev, card_line):
    """Slice D's training path: the ``100m`` preset (5,000 nodes, 9 layers,
    ~106M fp32 parameters) through ``examples/train_gcn.py``'s loop on K1,
    forward on A' and backward on A'^T. Returns K1's launches on the path."""
    import tempfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.graph import csr_transpose
    from repro_torch.examples import train_gcn as tg
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs)
    from repro_torch.models.gcn import GraphOp, gcn_loss, transform_first

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = tg.build_problem(TRAIN_PRESET, "gcn", "accel", dev)
    g = prob.graph
    fwd_plan, bwd_plan = prob.aggr.fwd.plan, prob.aggr.bwd.plan
    C = fwd_plan.config.deg_bound
    layers = len(prob.params)
    n_params = sum(t.numel() for p in prob.params for t in p.values())
    split = {name: int(p.partition.is_split.sum())
             for name, p in (("A'", fwd_plan), ("A'^T", bwd_plan))}
    log(f"train {TRAIN_PRESET}: {g.n_rows} nodes, {g.nnz} nnz after "
        f"gcn_normalize, {layers} layers, {n_params / 1e6:.1f}M parameters; "
        f"A' {fwd_plan.num_blocks} blocks, A'^T {bwd_plan.num_blocks} blocks,"
        f" split blocks {split}; built in {time.perf_counter() - t0:.1f}s")
    if split["A'^T"] == 0:
        raise AssertionError("A'^T has no split rows: the in-degree hubs of "
                             "the directed graph should make some")

    # step 0: K1 against the twin on the card, from the same parameters
    rel = grad_bound_rel(C, layers)
    twin = GraphOp.build(g, backend="blocked", device=dev)
    loss_k, grads_k = tg.loss_and_grads(prob.params, prob.aggr, prob.x,
                                        prob.labels)
    loss_t, grads_t = tg.loss_and_grads(prob.params, twin, prob.x,
                                        prob.labels)
    if abs(float(loss_k) - float(loss_t)) > rel * abs(float(loss_t)):
        raise AssertionError(f"step 0 loss {float(loss_k)} vs twin "
                             f"{float(loss_t)}")
    share = hold_grads(torch, "step 0", grads_k, grads_t, rel)
    log(f"train step 0: loss K1 {float(loss_k):.7f}, twin "
        f"{float(loss_t):.7f}; all {sum(len(p) for p in grads_k)} gradients "
        f"within {rel:.2e} x max|grad| of the twin's (largest share of the "
        f"bound {share:.3e})")
    del twin, grads_k, grads_t

    # one backward aggregation against the CSR oracle of A'^T
    gt = csr_transpose(g)
    up = torch.randn((g.n_rows, 4096), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(11))
    got = prob.aggr.bwd(up)
    want = csr_oracle(torch, gt, up, None)
    mag = csr_oracle(torch, gt, up, None, magnitude=True)
    k = torch.as_tensor(summation_k(gt, C, False), dtype=torch.float64,
                        device=dev)[:, None]
    err = check_close("bwd(g) vs A'^T oracle", got, want, U * k * mag)
    log(f"train: bwd(g) at F=4096 within the summation bound of the fp64 "
        f"CSR oracle of A'^T, max err {err:.2e}")
    del up, got, want, mag, k

    # the main path: SGD steps through the trainer's loop
    fwd, bwd = PlanCount(prob.aggr.fwd), PlanCount(prob.aggr.bwd)
    counted = GraphOp(fwd=fwd, bwd=bwd)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    per_step = []

    def on_step(s, _loss):
        events[s + 1].record()
        per_step.append(spmm_block_slabs.launches)

    spmm_block_slabs.launches = 0          # training path starts here
    spmm_block_slabs.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    events[0].record()
    losses = tg.train(prob.params, counted, prob.x, prob.labels,
                      variant="gcn", lr=1e-2, steps=TRAIN_STEPS,
                      on_step=on_step)
    torch.cuda.synchronize()
    launches = spmm_block_slabs.launches   # training path ends here
    by_instance = dict(spmm_block_slabs.launches_by_instance)
    step_ms = sorted(events[i].elapsed_time(events[i + 1])
                     for i in range(TRAIN_STEPS))
    steps_launches = [b - a for a, b in zip([0] + per_step, per_step)]
    log(f"train: {TRAIN_STEPS} SGD steps, losses "
        + ", ".join(f"{v:.6f}" for v in losses)
        + f"; K1 launches per step {steps_launches} (A' {fwd.launches}, "
        f"A'^T {bwd.launches}); by instance {by_instance}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite or not falling")
    # A'^T runs for every layer but one that aggregates its raw features
    bwd_per_step = sum(i > 0 or transform_first("gcn", *p["w"].shape, i > 0,
                                                True)
                       for i, p in enumerate(prob.params))
    if steps_launches != [layers + bwd_per_step] * TRAIN_STEPS or \
            fwd.launches != layers * TRAIN_STEPS or \
            bwd.launches != bwd_per_step * TRAIN_STEPS:
        raise AssertionError(f"K1 launches per step {steps_launches}, A' "
                             f"{fwd.launches}, A'^T {bwd.launches}: expected "
                             f"{layers} + {bwd_per_step} per step")

    # where a step's device time goes: K1 against everything else
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tg.loss_and_grads(prob.params, prob.aggr, prob.x, prob.labels)
        torch.cuda.synchronize()
    rows = [(evt.self_device_time_total / 1e3, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    k1_ms = sum(ms for ms, key in rows if "slot_order" in key)
    median = step_ms[len(step_ms) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if busy > 0:
        top = sorted(rows, reverse=True)[:4]
        log(f"train step profile: device busy {busy:.2f} ms, K1 {k1_ms:.2f} "
            f"ms ({k1_ms / busy * 100:.1f}% of device time); top: "
            + "; ".join(f"{ms:.2f} ms {key[:50]}" for ms, key in top))
        k1_text = f"K1 {k1_ms:.2f} ms of it by the profiler"
    else:
        k1_ms = None
        k1_text = "K1's share not measured (no device time profiled)"
    log(f"train {TRAIN_PRESET} step: median {median:.2f} ms of "
        f"{', '.join(f'{t:.2f}' for t in step_ms)} ms (CUDA events); "
        f"{k1_text}; peak device memory {peak:.2f} GiB; {card_line}")

    # a checkpoint of the final parameters restores bit for bit
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(TRAIN_STEPS, prob.params)
        back = mgr.restore(mgr.latest_step(), prob.params)
    for p, q in zip(prob.params, back):
        for key in p:
            if not (q[key].device == p[key].device
                    and torch.equal(q[key], p[key])):
                raise AssertionError(f"checkpoint: {key} not restored")
    with torch.no_grad():
        la = float(gcn_loss(prob.params, prob.aggr, prob.x, prob.labels))
        lb = float(gcn_loss(back, prob.aggr, prob.x, prob.labels))
    # split rows of A' add in arrival order (fp32 RED): the same parameters
    # give the same loss up to that order
    tol = 0.0 if split["A'"] == 0 else rel * abs(la)
    if abs(la - lb) > tol:
        raise AssertionError(f"restored loss {lb} vs {la}")
    log(f"train: checkpoint of step {TRAIN_STEPS} restored bit for bit, "
        f"loss {la:.7f} / {lb:.7f}")
    del prob, back, counted, fwd, bwd

    # sage and gin at the tiny preset, K1 against the twin
    for variant in ("sage", "gin"):
        small = tg.build_problem("tiny", variant, "accel", dev)
        twin = GraphOp.build(small.graph, backend="blocked", device=dev)
        nl = len(small.params)
        rel_v = grad_bound_rel(C, nl)
        lk, gk = tg.loss_and_grads(small.params, small.aggr, small.x,
                                   small.labels, variant)
        lt, gtw = tg.loss_and_grads(small.params, twin, small.x,
                                    small.labels, variant)
        if abs(float(lk) - float(lt)) > rel_v * abs(float(lt)):
            raise AssertionError(f"{variant}: loss {float(lk)} vs twin "
                                 f"{float(lt)}")
        s = hold_grads(torch, variant, gk, gtw, rel_v)
        log(f"train tiny {variant}: loss K1 {float(lk):.7f}, twin "
            f"{float(lt):.7f}, gradients within {rel_v:.2e} x max|grad| "
            f"(largest share {s:.3e})")
    return {"launches": launches, "step_ms": median, "k1_ms": k1_ms,
            "peak_gib": peak}


def chain_deltas(g, seed, integer, uniform=False, n=None):
    """``n`` (default MUTATE_DELTAS) deltas applied in turn from ``g``:
    each MUTATE_EDGES inserts at random and MUTATE_EDGES deletes, one
    existing edge from each of MUTATE_EDGES distinct non-empty rows, or
    with ``uniform`` drawn uniformly over the edges. (Uniform deletes land
    mostly on the hub rows, re-emit their split blocks at every repair and
    may trip the fragmentation guard.) Returns the deltas and the graphs of
    the chain (``g`` first)."""
    import numpy as np
    from repro_torch.core.plan_repair import EdgeDelta
    rng = np.random.default_rng(seed)
    graphs, deltas = [g], []
    for _ in range(MUTATE_DELTAS if n is None else n):
        cur = graphs[-1]
        k = MUTATE_EDGES
        deg = np.diff(cur.rowptr)
        if uniform:
            eids = rng.choice(cur.nnz, k, replace=False)
        else:
            rows = rng.choice(np.flatnonzero(deg > 0), k, replace=False)
            eids = cur.rowptr[rows] + rng.integers(0, deg[rows])
        vals = (rng.integers(1, 4, k) if integer
                else rng.uniform(0.01, 0.2, k))
        d = EdgeDelta(
            insert_src=rng.integers(0, cur.n_rows, k),
            insert_dst=rng.integers(0, cur.n_cols, k),
            insert_val=vals.astype(np.float32),
            delete_src=np.searchsorted(cur.rowptr, eids, side="right") - 1,
            delete_dst=cur.colidx[eids],
            on_duplicate="replace", on_missing="ignore")
        deltas.append(d)
        graphs.append(d.apply(cur))
    return deltas, graphs


def served_ms(torch, engine, name, x, reps=3):
    """Median host time of ``serve_one`` (the engine synchronizes before it
    answers)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.serve_one(name, x)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def arxiv_graphs():
    """The Arxiv analogue after gcn_normalize and its integer-valued copy
    (values 1-3), as phase 9 builds them."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph, gcn_normalize
    from repro_torch.data.graphs import make_benchmark_graph
    raw, _ = make_benchmark_graph(MUTATE_GRAPH, seed=1)
    norm = gcn_normalize(raw)
    ints = CSRGraph(norm.rowptr, norm.colidx, np.random.default_rng(2)
                    .integers(1, 4, norm.nnz).astype(np.float32),
                    norm.n_cols)
    return norm, ints


def phase_mutate(torch, dev, card_line):
    """Slice D's mutation path: the Arxiv analogue in an ``accel`` engine
    (K1) and an ``auto`` engine (K3, the hbm regime at F=2048), 4 deltas
    through ``mutate()`` with reads racing them, then the final version
    against a fresh build; the same on an integer-valued copy, exactly, and
    on that copy again with edge-uniform deletes, where rebuilds are logged
    and not asserted absent. Returns the K1 and K3 launches of the path."""
    from repro_torch.core.plan_cache import build_partition_plan
    from repro_torch.core.plan_repair import delta_chain_hash, repair_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    from repro_torch.serve.graph_engine import GraphServeEngine

    norm, ints = arxiv_graphs()
    engines = {"accel": GraphServeEngine(device=dev, backend="accel"),
               "auto": GraphServeEngine(device=dev, backend="auto")}
    kernel_of = {"accel": ops.spmm_accel, "auto": ops.spmm_pallas_hbm}
    C = engines["accel"].config.deg_bound
    nnz_chunk = 1 << 17
    gen = torch.Generator(device=dev).manual_seed(21)
    kernels = {"K1": spmm_block_slabs, "K3": spmm_block_slabs_hbm}
    compared = {"K1": 0, "K3": 0}
    for fn in kernels.values():            # mutation path starts here
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    t_main = time.perf_counter()
    for label, g0, integer, uniform in (
            ("float", norm, False, False), ("integer", ints, True, False),
            ("integer-uniform", ints, True, True)):
        if integer:
            x = torch.randint(-4, 5, (g0.n_cols, MUTATE_F), generator=gen,
                              device=dev).float()
        else:
            x = torch.randn((g0.n_cols, MUTATE_F), generator=gen,
                            device=dev)
        deltas, chain = chain_deltas(g0, seed=31, integer=integer,
                                     uniform=uniform)
        name = f"{MUTATE_GRAPH}-{label}"
        for be, eng in engines.items():
            t0 = time.perf_counter()
            eng.register_graph(name, g0)
            t_reg = time.perf_counter() - t0
            y = eng.serve_one(name, x)
            if integer:
                want = csr_oracle(torch, g0, x, nnz_chunk)
                if not torch.equal(y.double(), want):
                    raise AssertionError(f"{be} {label}: v0 not exact")
            else:
                csr_check(torch, g0, x, y, C, nnz_chunk)
            before = served_ms(torch, eng, name, x)

            # 4 deltas through mutate(), 2 readers submitting meanwhile
            answers, stop = [], threading.Event()

            def reader():
                for _ in range(3):
                    if stop.is_set():
                        return
                    answers.append(eng.submit(name, x).result(timeout=600))

            readers = [threading.Thread(target=reader) for _ in range(2)]
            for th in readers:
                th.start()
            infos, t_mut = [], []
            for d in deltas:                # one published version each
                t0 = time.perf_counter()
                infos.append(eng.mutate(name, d).result(timeout=600))
                t_mut.append(time.perf_counter() - t0)
            stop.set()
            for th in readers:
                th.join(timeout=600)
                if th.is_alive():
                    raise AssertionError("a reader thread did not finish")
            st = eng.stats()
            if eng.graph_version(name) != MUTATE_DELTAS or (
                    not uniform and (not all(i["repaired"] for i in infos)
                                     or st["plan_rebuilds"] != 0)):
                raise AssertionError(f"{be} {label}: {infos}, rebuilds "
                                     f"{st['plan_rebuilds']}")
            seen = set()
            for y in answers:
                seen.add(match_version(torch, chain, x, y, C, nnz_chunk,
                                       integer))
            after = served_ms(torch, eng, name, x)
            final = eng.serve_one(name, x)
            # the final version against a fresh build through the same
            # kernel, and against the oracle
            g_end = chain[-1]
            t0 = time.perf_counter()
            fresh = build_partition_plan(g_end, eng.config, device=dev)
            torch.cuda.synchronize()
            t_fresh = time.perf_counter() - t0
            held = {k: fn.launches for k, fn in kernels.items()}
            fy = kernel_of[be](fresh.slabs, x, fresh.n_rows)[fresh.inv_perm]
            torch.cuda.synchronize()
            for k, fn in kernels.items():    # a comparison, not the path
                compared[k] += fn.launches - held[k]
            if integer:
                want = csr_oracle(torch, g_end, x, nnz_chunk)
                if not (torch.equal(final, fy)
                        and torch.equal(final.double(), want)):
                    raise AssertionError(f"{be} {label}: final version not "
                                         f"exact")
                err = 0.0
            else:
                csr_check(torch, g_end, x, final, C, nnz_chunk)
                k = torch.as_tensor(summation_k(g_end, C, False),
                                    dtype=torch.float64, device=dev)[:, None]
                mag = csr_oracle(torch, g_end, x, nnz_chunk, magnitude=True)
                err = check_close(f"{be} repaired vs fresh", final, fy,
                                  2 * U * k * mag)
                del k, mag
            log(f"mutate {be} {label}: {MUTATE_DELTAS} deltas x "
                f"({MUTATE_EDGES} inserts + {MUTATE_EDGES} deletes) = "
                f"{sum(d.size for d in deltas)} edges of {g0.nnz} nnz; "
                f"versions {[i['version'] for i in infos]}, dirty rows "
                f"{[i['dirty_rows'] for i in infos]}, repaired "
                f"{[i['repaired'] for i in infos]}, repairs "
                f"{st['plan_repairs']}, rebuilds {st['plan_rebuilds']}; "
                f"{len(answers)} racing reads matched versions "
                f"{sorted(seen)}; final vs fresh build max err {err:.2e}; "
                f"register {t_reg:.2f}s, mutate() to published "
                f"{', '.join(f'{t:.3f}' for t in t_mut)}s, fresh build "
                f"{t_fresh:.2f}s; served F={MUTATE_F} {before:.1f} ms "
                f"before, {after:.1f} ms after; {card_line}")
            for v, i in enumerate(infos, 1):
                if not i["repaired"]:
                    log(f"mutate {be} {label}: version {v} rebuilt: "
                        f"{i['reason']}")
            del answers, fresh, fy, final, y
        del x, chain, deltas

    t_main = time.perf_counter() - t_main
    launches = {k: fn.launches - compared[k]              # path ends
                for k, fn in kernels.items()}
    routed = {"K1": engines["accel"].stats()["routed_resident"]
              + engines["auto"].stats()["routed_resident"],
              "K3": engines["auto"].stats()["routed_hbm"]}
    log(f"mutation path: launches {launches}, engines' dispatches {routed}; "
        f"{t_main:.1f}s including the oracle checks")
    if launches != routed or min(launches.values()) < 1:
        raise AssertionError(f"mutation path launches {launches} differ "
                             f"from the dispatches {routed}")
    for eng in engines.values():
        eng.close()

    # one delta's two host steps against a fresh build, on the host clock
    plan = build_partition_plan(norm, engines["accel"].config, device=dev)
    deltas, chain = chain_deltas(norm, seed=31, integer=False)
    d = deltas[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_new = d.apply(norm)
    t_apply = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv = repair_plan(plan, norm, g_new, d.touched_rows(),
                     graph_hash=delta_chain_hash(plan.graph_hash, d))
    torch.cuda.synchronize()
    t_rep = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_partition_plan(chain[1], engines["accel"].config, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"mutate: one delta of {d.size} edges: EdgeDelta.apply "
        f"(csr_apply_edge_delta) {t_apply * 1e3:.1f} ms, repair_plan "
        f"{t_rep * 1e3:.1f} ms ({pv.reason}); a fresh build of the "
        f"post-delta plan {t_build * 1e3:.1f} ms; {card_line}")
    return launches


def match_version(torch, chain, x, y, C, nnz_chunk, integer):
    """The index of the version in ``chain`` whose product ``y`` equals
    (exactly on integer graphs, else within the summation bound); raises
    when none does."""
    for v in range(len(chain) - 1, -1, -1):
        g = chain[v]
        want = csr_oracle(torch, g, x, nnz_chunk)
        if integer:
            ok = torch.equal(y.double(), want)
        else:
            mag = csr_oracle(torch, g, x, nnz_chunk, magnitude=True)
            k = torch.as_tensor(summation_k(g, C, False), dtype=torch.float64,
                                device=x.device)[:, None]
            ok = bool(((y.double() - want).abs() <= U * k * mag).all())
        if ok:
            return v
    raise AssertionError("a read racing the mutations matches no version")


# ------------------------------------------------------------ slice E
TUNE_F = 2048              # phase 13's candidate checks and tune_offline
TUNE_DISPATCHES = 1200     # phase 13(d): live F=256 dispatches
TUNE_LIVE_F = 256
SAMPLE_GRAPH = "Reddit"
SAMPLE_FANOUTS = [10, 10, 5, 5, 5]   # phase 14(c), one per GCN layer
SAMPLE_BATCHES = 2                    # distinct capped seed batches
SAMPLE_BATCH = 256
SAMPLE_SEEDS = 32                     # phase 14(a), (b), (d)


def k_of(g, configs):
    """Per-row k of the summation bound (original row order) valid for a
    plan of any of ``configs``: the largest over their slab capacities."""
    import numpy as np
    return np.max([summation_k(g, c.deg_bound, False) for c in configs],
                  axis=0)


def candidate_shapes():
    """(base, candidate) for every candidate of the tpu default and of
    paper (12, 32): every slab shape phase 13 promotes or measures."""
    from repro_torch.core.plan_cache import PartitionConfig
    from repro_torch.tuning import default_candidates
    return [(base, c) for base in (PartitionConfig(),
                                   PartitionConfig("paper", 12, 32))
            for c in default_candidates(base)]


def phase_tune(torch, dev, card_line):
    """Slice E's autotuning path on the Arxiv analogue: (a) every candidate
    slab shape through K1, K2 and K3, exact on the integer copy; (b)
    ``tune_offline`` at F=2048; (c) a forced promotion through a live
    ``accel`` engine serving the 25m GCN's layers, answers held before and
    after; (d) the default policy under closed-loop F=256 traffic, the
    live dispatch's p50 with and without a shadow in flight. Returns K1's
    launches on the path ((c) and (d)) and the log's numbers."""
    from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs)
    from repro_torch.models.layers import dense_init
    from repro_torch.tuning import default_candidates, tune_offline

    t_phase = time.perf_counter()
    norm, ints = arxiv_graphs()
    nnz_chunk = 1 << 17
    gen = torch.Generator(device=dev).manual_seed(41)

    # (a) every candidate shape through K1, K2 and K3, exactly
    t0 = time.perf_counter()
    x_int = torch.randint(-4, 5, (ints.n_cols, TUNE_F), generator=gen,
                          device=dev).float()
    want = csr_oracle(torch, ints, x_int, nnz_chunk)
    kernels = {"K1": ops.spmm_accel, "K2": ops.spmm_pallas_windowed,
               "K3": ops.spmm_pallas_hbm}
    for base, cand in candidate_shapes():
        tb = time.perf_counter()
        plan = build_partition_plan(ints, cand.config, device=dev)
        t_build = time.perf_counter() - tb
        for k, fn in kernels.items():
            y = fn(plan.slabs, x_int, plan.n_rows)[plan.inv_perm]
            torch.cuda.synchronize()
            if not torch.equal(y.double(), want):
                raise AssertionError(f"{k} on candidate {cand.label} of "
                                     f"{base}: not exact")
            del y
        log(f"tune (a) {base.mode}({base.max_block_warps},"
            f"{base.max_warp_nzs}) {cand.label}: C={plan.slabs['C']} "
            f"R={plan.slabs['R']}, {plan.num_blocks} blocks "
            f"({int(plan.partition.is_split.sum())} split), built in "
            f"{t_build:.2f}s; K1, K2, K3 exact at F={TUNE_F}")
        del plan
    del x_int, want
    log(f"tune (a): {len(candidate_shapes())} candidate shapes x 3 kernels "
        f"exact in {time.perf_counter() - t0:.1f}s")

    # (b) tune_offline: every default candidate of the tpu base, timed
    t0 = time.perf_counter()
    rep = tune_offline(norm, PartitionConfig(), feat_dim=TUNE_F, repeats=5,
                       backend="accel", device=dev)
    log(f"tune (b) tune_offline Arxiv F={TUNE_F} accel (CUDA events, 1 "
        f"warm-up, best of 5): base {rep['base']['time_s'] * 1e3:.3f} ms; "
        f"{card_line}")
    for row in rep["candidates"]:
        if "error" in row:
            raise AssertionError(f"tune_offline candidate {row['label']} "
                                 f"raised: {row['error']}")
        log(f"tune (b) {row['label']}: {row['time_s'] * 1e3:.3f} ms, "
            f"{row['speedup_vs_base']:.3f}x the base")
    best = rep["best"]
    cands = default_candidates(PartitionConfig())
    won = best is not None and rep["best_speedup"] > 1.0
    cand = next(c for c in cands if c.label == best["label"]) if won \
        else cands[0]
    log(f"tune (b): {len(cands)} candidates in "
        f"{time.perf_counter() - t0:.1f}s; best {best['label']} at "
        f"{rep['best_speedup']:.3f}x; phase (c) forces "
        f"{cand.label} ({'the winner' if won else 'none won: the first'})")

    # (c) forced promotion through a live engine, float and integer graphs
    dims = DIMS + [N_CLASSES]
    wgen = torch.Generator().manual_seed(0)
    weights = [dense_init(wgen, a, b, torch.float32, device=dev)
               for a, b in zip(dims[:-1], dims[1:])]
    spmm_block_slabs.launches = 0          # the tune path starts here
    spmm_block_slabs.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    t_path = time.perf_counter()
    k = {}
    for label, g in (("float", norm), ("integer", ints)):
        k[label] = torch.as_tensor(
            k_of(g, [PartitionConfig(), cand.config]), dtype=torch.float64,
            device=dev)[:, None]
    forced = {}
    for label, g in (("float", norm), ("integer", ints)):
        forced[label] = promote_through_engine(
            torch, dev, label, g, cand, weights, k[label], nnz_chunk, gen)
    # (d) the reference's default policy under closed-loop F=256 reads
    live = default_policy_run(torch, dev, norm, k_of(norm, [
        PartitionConfig()] + [c.config for c in cands]), nnz_chunk, gen)
    launches = spmm_block_slabs.launches            # the tune path ends
    by_instance = dict(spmm_block_slabs.launches_by_instance)
    expected = sum(r["expected_launches"] for r in forced.values()) \
        + live["expected_launches"]
    log(f"tune path: K1 launches {launches} (by instance {by_instance}), "
        f"live dispatches + 5 per shadow = {expected}; "
        f"{time.perf_counter() - t_path:.1f}s")
    if launches != expected or launches < 1:
        raise AssertionError(f"tune path: K1 launches {launches} != live "
                             f"dispatches + 5 per shadow {expected}")
    log(f"phase 13 (autotuning) {time.perf_counter() - t_phase:.1f}s")
    return {"K1": launches, "offline": rep, "forced": cand.label,
            "p50": live}


def promote_through_engine(torch, dev, label, g, cand, weights, k,
                           nnz_chunk, gen):
    """Phase 13(c): an ``accel`` engine whose tuner wins every comparison
    serves the GCN's layers on ``g`` until its one candidate is promoted
    and a whole pass has been served after it. The float graph serves the
    chained layers (held within the summation bound, ``k`` valid for both
    plans); the integer copy serves integer features at each layer's width
    (held exactly). Returns the launches the run must have made."""
    from repro_torch.serve.graph_engine import GraphServeEngine
    from repro_torch.tuning import PlanTuner

    integer = label == "integer"
    engine = GraphServeEngine(device=dev, backend="accel", tuner=PlanTuner(
        hot_rate=0.0, shadow_fraction=1.0, win_streak=2,
        min_improvement=-100.0, max_trials=4, candidates=[cand]))
    name = f"{MUTATE_GRAPH}-{label}"
    engine.register_graph(name, g)
    v0 = engine.graph_version(name)
    c0 = engine.plan_for(name).config
    seen = {"before": 0, "during": 0, "after": 0}
    errs = []
    t0 = time.perf_counter()
    passes_after = 0
    for rnd in range(8):
        h = torch.randn((g.n_cols, weights[0].shape[0]), generator=gen,
                        device=dev)
        whole_after = engine.stats()["tuned_promotions"] == 1
        for li, w in enumerate(weights):
            if integer:
                xw = torch.randint(-4, 5, (g.n_cols, w.shape[1]),
                                   generator=gen, device=dev).float()
            else:
                xw = h @ w
            p_before = engine.stats()["tuned_promotions"]
            y = engine.serve_one(name, xw)
            p_after = engine.stats()["tuned_promotions"]
            seen["after" if p_before else "before" if not p_after
                 else "during"] += 1
            want = csr_oracle(torch, g, xw, nnz_chunk)
            if integer:
                if not torch.equal(y.double(), want):
                    raise AssertionError(f"tune (c) {label} round {rnd} "
                                         f"layer {li}: not exact")
            else:
                mag = csr_oracle(torch, g, xw, nnz_chunk, magnitude=True)
                errs.append(check_close(f"tune (c) {label} round {rnd} layer "
                                        f"{li}", y, want, U * k * mag))
                del mag
            h = torch.relu(y) if li < len(weights) - 1 else y
            del want, xw
        passes_after += whole_after
        if passes_after >= 1:
            break
    engine.close()                  # waits for a shadow still in flight
    st = engine.stats()
    plan = engine.plan_for(name)
    log(f"tune (c) {label}: promoted {plan.tuned} (config {plan.config}) "
        f"at version {plan.version} (was {v0}, {c0}); answers before "
        f"{seen['before']}, during {seen['during']}, after {seen['after']}"
        + (f", max err {max(errs):.2e}" if errs else ", all exact")
        + f"; dispatches {st['batches_dispatched']}, shadows "
        f"{st['shadow_dispatches']} ({st['shadow_time_s']:.2f}s), skipped "
        f"{st['shadow_skipped']}, failures {st['shadow_failures']}; "
        f"{time.perf_counter() - t0:.1f}s")
    if st["tuned_promotions"] != 1 or st["shadow_failures"] != 0:
        raise AssertionError(f"tune (c) {label}: {st['tuned_promotions']} "
                             f"promotions, {st['shadow_failures']} failures")
    if plan.config != cand.config or (plan.tuned or {}).get("label") \
            != cand.label or plan.version != v0 + 1:
        raise AssertionError(f"tune (c) {label}: served plan {plan.config} "
                             f"{plan.tuned} v{plan.version}")
    if not seen["before"] or not seen["after"]:
        raise AssertionError(f"tune (c) {label}: answers {seen}")
    return {"expected_launches": st["batches_dispatched"]
            + 5 * st["shadow_dispatches"]}


def default_policy_run(torch, dev, g, k, nnz_chunk, gen):
    """Phase 13(d): an ``accel`` engine with ``PlanTuner()`` at the
    reference's defaults serves TUNE_DISPATCHES reads of F=256 back to
    back. Each read's dispatch time (the engine's ``total_serve_s``
    step: merge, kernel, un-permute, synchronize) is filed under "without"
    a shadow, or, when one was in flight at its start or end, under
    "building" (the shadow worker was building a candidate plan on the
    host: the plan cache had a build in flight) or "measuring" (its
    launches); every 100th answer is held to the summation bound (``k``
    valid for any candidate's plan)."""
    import numpy as np
    from repro_torch.serve.graph_engine import GraphServeEngine
    from repro_torch.tuning import PlanTuner

    engine = GraphServeEngine(device=dev, backend="accel", tuner=PlanTuner())
    engine.register_graph("Arxiv", g)
    x = torch.randn((g.n_cols, TUNE_LIVE_F), generator=gen, device=dev)
    kt = torch.as_tensor(k, dtype=torch.float64, device=dev)[:, None]
    times = {"without": [], "building": [], "measuring": []}

    def shadow_state():
        # live reads hit a cached plan, so a build in flight is the shadow's
        st = engine.stats()
        if not st["shadow_in_flight"]:
            return 0
        return 2 if st["cache_builds_in_flight"] else 1

    t0 = time.perf_counter()
    for i in range(TUNE_DISPATCHES):
        state = shadow_state()
        before = engine.total_serve_s
        y = engine.serve_one("Arxiv", x)
        dt = engine.total_serve_s - before
        state = max(state, shadow_state())
        times[("without", "measuring", "building")[state]].append(dt * 1e3)
        if i % 100 == 0:
            want = csr_oracle(torch, g, x, nnz_chunk)
            mag = csr_oracle(torch, g, x, nnz_chunk, magnitude=True)
            check_close(f"tune (d) read {i}", y, want, U * kt * mag)
            del want, mag
    wall = time.perf_counter() - t0
    engine.close()
    st = engine.stats()
    with_shadow = times["building"] + times["measuring"]
    p50 = {"without": float(np.median(times["without"])),
           "with": float(np.median(with_shadow)) if with_shadow else None}
    log(f"tune (d) default PlanTuner(), Arxiv F={TUNE_LIVE_F}, "
        f"{TUNE_DISPATCHES} closed-loop reads in {wall:.1f}s: comparisons "
        f"{st['tuner_comparisons']}, wins {st['tuner_wins']}, promotions "
        f"{st['tuner_promotions']}, candidates exhausted "
        f"{st['tuner_exhausted_graphs']}, failures "
        f"{st['tuner_candidate_failures']}; shadows "
        f"{st['shadow_dispatches']} ({st['shadow_time_s']:.2f}s on the "
        f"worker), skipped {st['shadow_skipped']}; state "
        f"{engine.tuner.describe('Arxiv')}; served plan "
        f"{engine.plan_for('Arxiv').tuned}")
    log("tune (d) live dispatch p50 / p90 (ms): " + "; ".join(
        f"{side} {np.median(ts):.3f} / {np.percentile(ts, 90):.3f} "
        f"({len(ts)} reads)"
        for side, ts in (("without a shadow", times["without"]),
                         ("with one in flight", with_shadow),
                         ("its plan build", times["building"]),
                         ("its launches", times["measuring"])) if ts))
    if st["shadow_failures"]:
        raise AssertionError(f"tune (d): {st['shadow_failures']} shadow "
                             f"failures")
    return {"expected_launches": st["batches_dispatched"]
            + 5 * st["shadow_dispatches"], "p50_without_ms": p50["without"],
            "p50_with_ms": p50["with"], "n_with": len(with_shadow),
            "comparisons": st["tuner_comparisons"],
            "promotions": st["tuner_promotions"]}


class TimedSampler:
    """A store's ``sample_in_neighbors`` with its host time per call."""

    def __init__(self, store):
        self.store = store
        self.ms = []

    def sample_in_neighbors(self, nodes, fanout=None, **kw):
        t0 = time.perf_counter()
        out = self.store.sample_in_neighbors(nodes, fanout, **kw)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def timed_registration_engine():
    """A ``GraphServeEngine`` whose ``register_subgraph`` (the service's
    call that registers a hop's block and builds its plan) keeps its host
    time per call in ``reg_ms``."""
    from repro_torch.serve.graph_engine import GraphServeEngine

    class TimedRegistrationEngine(GraphServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.reg_ms = []

        def register_subgraph(self, *a, **kw):
            t0 = time.perf_counter()
            gid = super().register_subgraph(*a, **kw)
            self.reg_ms.append((time.perf_counter() - t0) * 1e3)
            return gid

    return TimedRegistrationEngine


def frontier_oracle(torch, f, x, params, nnz_chunk, C):
    """The GCN over a frontier's blocks, outermost first, in fp64 through
    the CSR oracle, and the same on absolute values; returns (the answer,
    the magnitude, the bound's depth c) at the frontier's hop-0 rows.
    ``c`` sums per layer the GEMM depth K, the largest summation k of the
    block's rows and 1 for the bias: a served fp32 answer is within
    ``c * u * magnitude`` of the fp64 one (first order)."""
    idx = torch.as_tensor(f.input_nodes, device=x.device)
    h = x[idx].double()
    m = h.abs()
    L = f.num_hops
    c = 0
    for i, p in enumerate(params):
        blk = f.blocks[L - 1 - i].graph
        w = p["w"].double()
        h = csr_oracle(torch, blk, h @ w, nnz_chunk) + p["b"].double()
        m = csr_oracle(torch, blk, m @ w.abs(), nnz_chunk, magnitude=True) \
            + p["b"].double().abs()
        if i < L - 1:
            h = torch.relu(h)
        c += int(w.shape[0]) + int(summation_k(blk, C, False).max()) + 1
    return h, m, c


def phase_sample(torch, dev, card_line):
    """Slice E's sampled serving on the Reddit analogue through an ``auto``
    engine with the 25m GCN (5 layers, 5 hops): (a) full fanout against
    full-graph serving; (b) an exact 2-hop aggregate on an integer store;
    (c) capped fanouts, 2 batches served twice each, against the fp64
    oracle of each frontier, with the host's and the card's times per
    frontier; (d) a delta into the live integer store. The K1, K2 and K3
    launches of the phase, less the full-graph reference's and the timing
    comparisons', must equal the sampling engine's routed counts."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph
    from repro_torch.core.plan_repair import EdgeDelta
    from repro_torch.data.graphs import (make_benchmark_graph, seed_batches,
                                         seed_splits)
    from repro_torch.kernels import ops
    from repro_torch.kernels.router import route_spmm
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs,
                                                spmm_block_slabs_windowed)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    from repro_torch.models.layers import dense_init
    from repro_torch.sampling import GraphStore, SamplingService
    from repro_torch.serve.graph_engine import GraphServeEngine

    t_phase = time.perf_counter()
    raw, _ = make_benchmark_graph(SAMPLE_GRAPH, seed=0)
    t0 = time.perf_counter()
    store = GraphStore.build(raw, normalize=True)
    n = store.n_nodes
    log(f"sample: {SAMPLE_GRAPH} store {n} nodes, {store.n_edges} nnz "
        f"(normalized, both orientations) built in "
        f"{time.perf_counter() - t0:.1f}s")
    engine = timed_registration_engine()(device=dev, backend="auto")
    C = engine.config.deg_bound
    nnz_chunk = 1 << 17
    wgen = torch.Generator().manual_seed(0)
    params = [{"w": dense_init(wgen, a, b, torch.float32, device=dev),
               "b": torch.zeros((b,), device=dev)}
              for a, b in zip(DIMS[:-1], DIMS[1:])]
    gen = torch.Generator(device=dev).manual_seed(51)
    x = torch.randn((n, DIMS[0]), generator=gen, device=dev)
    rng = np.random.default_rng(52)
    kernels = {"K1": spmm_block_slabs, "K2": spmm_block_slabs_windowed,
               "K3": spmm_block_slabs_hbm}
    compared = dict.fromkeys(kernels, 0)
    for fn in kernels.values():            # the sample path starts here
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)

    # (a) full fanout through 5 hops == full-graph serving at the seeds;
    # the full graph is served by an engine of its own, and its launches
    # (slice A's path, the reference answer) are not the sample path's
    t0 = time.perf_counter()
    held = {kk: fn.launches for kk, fn in kernels.items()}
    full_engine = GraphServeEngine(device=dev, backend="auto")
    full_engine.register_graph("full", store.in_adj)
    h = x
    for i, p in enumerate(params):
        h = full_engine.submit("full", h @ p["w"]).result() + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    full_engine.close()
    del full_engine
    full_launches = {kk: fn.launches - held[kk]
                     for kk, fn in kernels.items()}
    for kk in kernels:
        compared[kk] += full_launches[kk]
    svc_full = SamplingService(engine, store, [None] * len(params),
                               store=store)
    seeds = rng.choice(n, SAMPLE_SEEDS, replace=False)
    out = svc_full.infer(seeds, x, params)
    f = svc_full.frontier_for(seeds)
    rows = torch.as_tensor(np.searchsorted(f.layers[0], seeds), device=dev)
    _, m, c = frontier_oracle(torch, f, x, params, nnz_chunk, C)
    want = h[torch.as_tensor(seeds, device=dev)]
    err = check_close("sample (a) full fanout vs full graph", out, want,
                      2 * U * c * m[rows])
    L = f.num_hops
    regimes = []                # the router's decision per hop (no launch)
    for i, p in enumerate(params):
        blk = f.blocks[L - 1 - i].graph
        plan = engine.plan_for(engine.register_subgraph(blk,
                                                        prefix="frontier"))
        d = route_spmm(blk.n_cols, p["w"].shape[1], int(plan.slabs["C"]),
                       int(plan.slabs["R"]))
        regimes.append(f"hop {L - 1 - i} {d.backend}")
    log(f"sample (a) full fanout {len(params)} hops, {SAMPLE_SEEDS} seeds: "
        f"layers {[len(l) for l in f.layers]}, block nnz "
        f"{[b.n_edges for b in f.blocks]}, routed {', '.join(regimes)}; "
        f"max err {err:.2e} against full-graph serving (bound 2 c u |.|, "
        f"c={c}; the full-graph reference launched {full_launches}, not "
        f"counted on the sample path); {time.perf_counter() - t0:.1f}s")
    del h, out, want, m

    # (b) exact 2-hop aggregation on an integer store (values 1)
    t0 = time.perf_counter()
    istore = GraphStore.build(CSRGraph(raw.rowptr, raw.colidx, np.ones(
        raw.nnz, np.float32), raw.n_cols))
    isvc = SamplingService(engine, istore, [None, None], store=istore)
    xi = torch.randint(-4, 5, (n, TUNE_LIVE_F), generator=gen,
                       device=dev).float()
    iseeds = rng.choice(n, SAMPLE_SEEDS, replace=False)

    def two_hop(a):
        sel = torch.as_tensor(iseeds, device=dev)
        want = csr_oracle(torch, a, csr_oracle(torch, a, xi, nnz_chunk),
                          nnz_chunk)[sel]
        mag = csr_oracle(torch, a, csr_oracle(torch, a, xi, nnz_chunk,
                                              magnitude=True),
                         nnz_chunk, magnitude=True)[sel]
        # every partial sum stays below 2**24: fp32 integer sums are exact
        if float(mag.max()) >= 2.0 ** 24:
            raise AssertionError(f"2-hop magnitude {float(mag.max())} at "
                                 f"the seeds: fp32 sums would round")
        return want, float(mag.max())

    got = isvc.aggregate(iseeds, xi)
    want, mag_max = two_hop(istore.in_adj)
    if not torch.equal(got.double(), want):
        raise AssertionError("sample (b): 2-hop aggregate not exact")
    fi = isvc.frontier_for(iseeds)
    log(f"sample (b) integer store, 2-hop full fanout aggregate F="
        f"{TUNE_LIVE_F}, {SAMPLE_SEEDS} seeds: layers "
        f"{[len(l) for l in fi.layers]}, exact (largest magnitude "
        f"{mag_max:.0f} < 2^24); {time.perf_counter() - t0:.1f}s")

    # (c) capped fanouts: 2 distinct batches, each served twice
    t0 = time.perf_counter()
    sampler = TimedSampler(store)
    svc = SamplingService(engine, sampler, SAMPLE_FANOUTS, store=store)
    reg_ms = engine.reg_ms
    train, _ = seed_splits(n, [0.5, 0.2], seed=3)
    batches = [b for _, b in zip(range(SAMPLE_BATCHES), seed_batches(
        train, SAMPLE_BATCH, seed=4))]
    served = []
    for b in batches:
        sampler.ms.clear()
        reg_ms.clear()
        tb = time.perf_counter()
        y_miss = svc.infer(b, x, params)
        torch.cuda.synchronize()
        t_miss = time.perf_counter() - tb
        sample_ms, build_ms = list(sampler.ms), sum(reg_ms)
        tb = time.perf_counter()
        y_hit = svc.infer(b, x, params)
        torch.cuda.synchronize()
        t_hit = time.perf_counter() - tb
        served.append((b, y_miss, y_hit, t_miss, t_hit, sample_ms, build_ms))
    st = svc.stats()
    if (st["frontier_misses"], st["frontier_hits"]) != (SAMPLE_BATCHES,
                                                        SAMPLE_BATCHES):
        raise AssertionError(f"sample (c): stats {st}")
    for b, y_miss, y_hit, t_miss, t_hit, sample_ms, build_ms in served:
        f = svc.frontier_for(b)
        rows = torch.as_tensor(np.searchsorted(f.layers[0], b), device=dev)
        h64, m, c = frontier_oracle(torch, f, x, params, nnz_chunk, C)
        errs = [check_close(f"sample (c) {which}", y, h64[rows],
                            U * c * m[rows])
                for which, y in (("miss", y_miss), ("hit", y_hit))]
        # per hop: the routed kernel on the hop's plan (a comparison, not
        # the path) and the dense product, by CUDA events
        hops, gemm_ms = [], []
        L = f.num_hops
        for i, p in enumerate(params):
            blk = f.blocks[L - 1 - i]
            # the block's content-derived id (registered: no rebuild)
            plan = engine.plan_for(engine.register_subgraph(
                blk.graph, prefix="frontier"))
            z = torch.randn((blk.graph.n_cols, p["w"].shape[1]),
                            generator=gen, device=dev)
            hz = torch.randn((blk.graph.n_cols, p["w"].shape[0]),
                             generator=gen, device=dev)
            held = {kk: fn.launches for kk, fn in kernels.items()}
            _, d = ops.spmm_auto(plan.slabs, z, plan.n_rows,
                                 return_decision=True)
            ms = cuda_ms(lambda: ops.spmm_auto(plan.slabs, z, plan.n_rows),
                         5)
            for kk, fn in kernels.items():
                compared[kk] += fn.launches - held[kk]
            hz @ p["w"]
            gemm_ms.append(cuda_ms(lambda: hz @ p["w"], 5))
            hops.append(f"hop {L - 1 - i} ({blk.graph.n_rows}x"
                        f"{blk.graph.n_cols}, {blk.n_edges} nnz, F="
                        f"{p['w'].shape[1]}) {d.backend} {ms:.3f} ms")
            del z, hz
        log(f"sample (c) fanouts {SAMPLE_FANOUTS}, {len(b)} seeds: layers "
            f"{[len(l) for l in f.layers]}; miss {t_miss * 1e3:.1f} ms "
            f"(host sampling {sum(sample_ms):.1f} ms: "
            f"{', '.join(f'{v:.1f}' for v in sample_ms)}; block "
            f"registration and plan builds {build_ms:.1f} ms), hit "
            f"{t_hit * 1e3:.1f} ms = {len(b) / t_hit:.0f} seeds/s; device "
            f"per hop: {'; '.join(hops)}; dense GEMM ms per layer "
            f"{', '.join(f'{v:.3f}' for v in gemm_ms)}; max err miss "
            f"{errs[0]:.2e}, hit {errs[1]:.2e} (bound c u |.|, c={c}); "
            f"{card_line}")
    log(f"sample (c): {time.perf_counter() - t0:.1f}s")

    # (d) a delta into the live integer store, aimed at (b)'s seeds
    t0 = time.perf_counter()
    fi = isvc.frontier_for(iseeds)
    dst = fi.layers[0][:8]
    src = rng.choice(fi.layers[1], len(dst))
    before = isvc.stats()
    istore.apply_delta(EdgeDelta(insert_src=src, insert_dst=dst,
                                 insert_val=np.ones(len(dst), np.float32),
                                 on_duplicate="replace"))
    after = isvc.stats()
    mutated = after["frontier_mutations"] - before["frontier_mutations"]
    dropped = after["frontiers_invalidated"] - before["frontiers_invalidated"]
    if mutated < 1 and dropped < 1:
        raise AssertionError(f"sample (d): the delta neither repaired nor "
                             f"dropped the cached frontier: {after}")
    got = isvc.aggregate(iseeds, xi)
    want, _ = two_hop(istore.in_adj)
    if not torch.equal(got.double(), want):
        raise AssertionError("sample (d): post-delta aggregate not exact")
    log(f"sample (d) {len(dst)} inserts aimed at the seeds: frontiers "
        f"repaired through mutate() {mutated}, dropped {dropped}; engine "
        f"mutations {engine.stats()['mutations_applied']}; post-delta "
        f"aggregate exact; {time.perf_counter() - t0:.1f}s")

    engine.close()
    es = engine.stats()
    launches = {kk: fn.launches - compared[kk]       # the sample path ends
                for kk, fn in kernels.items()}
    routed = {"K1": es["routed_resident"], "K2": es["routed_windowed"],
              "K3": es["routed_hbm"]}
    log(f"sample path: launches {launches}, engine's routed counts "
        f"{routed}; phase 14 (sampled serving) "
        f"{time.perf_counter() - t_phase:.1f}s")
    if launches != routed or launches["K1"] < 1:
        raise AssertionError(f"sample path launches {launches} differ from "
                             f"the routed dispatches {routed}")
    return launches


# ------------------------------------------------------------ slice C1
# K4 edge cases: rows per expert in blocks (0 = an expert with no rows),
# trailing blocks past the last expert (clipped to E-1, zero rows), m_tile.
# tests/test_torch_kernels_gpu.py holds the same cases: this script imports
# nothing of the tests, so it keeps its own copy.
K4_CASES = {
    "empty_expert": ([2, 0, 1, 3], 0, 16),
    "single_expert": ([4], 0, 16),
    "trailing_blocks": ([1, 2, 0], 3, 8),
    "m_tile_128": ([2, 1, 0, 1], 1, 128),
    "m_tile_160": ([1, 0, 2], 1, 160),
}


def gmm_oracle(torch, x, w, be, m_tile):
    """fp64 ``out[b-th block rows] = x[rows] @ w[be[b]]`` and the same with
    |x| and |w| (the magnitude that scales the summation bound)."""
    M = x.shape[0]
    out = torch.zeros((M, w.shape[2]), dtype=torch.float64, device=x.device)
    mag = torch.zeros_like(out)
    for b, e in enumerate(be.tolist()):
        rows = slice(b * m_tile, (b + 1) * m_tile)
        xb, we = x[rows].double(), w[e].double()
        out[rows] = xb @ we
        mag[rows] = xb.abs() @ we.abs()
    return out, mag


# the wgmma instance's edge cases: rows per expert in blocks, trailing
# clipped blocks; each at m_tile 64, 128, 192 and 256
K4_WGMMA_CASES = {
    "empty_expert": ([2, 0, 1, 3], 0),
    "single_expert": ([3], 0),
    "trailing_blocks": ([1, 2, 0], 3),
}


def k4_case(torch, dev, gen, case, K, N, xd, wd, integer):
    blocks, trailing, m_tile = K4_CASES[case]
    return k4_blocks(torch, dev, gen, blocks, trailing, m_tile, K, N, xd, wd,
                     integer)


def k4_blocks(torch, dev, gen, blocks, trailing, m_tile, K, N, xd, wd,
              integer):
    E = len(blocks)
    be = torch.cat([torch.arange(E, device=dev).repeat_interleave(
        torch.tensor(blocks, device=dev)),
        torch.full((trailing,), E - 1, device=dev)]).to(torch.int32)
    M = be.numel() * m_tile
    if integer:
        x = torch.randint(-2, 3, (M, K), generator=gen, device=dev).float()
        w = torch.randint(-2, 3, (E, K, N), generator=gen, device=dev).float()
    else:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((E, K, N), generator=gen, device=dev)
    x[M - trailing * m_tile:] = 0
    return x.to(xd), w.to(wd), be, m_tile


def k4_on(torch, instance, x, w, be, m_tile, **tiles):
    """K4 through its public wrapper, checking that ``instance`` ran it."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    before = grouped_matmul.launches_by_instance[instance]
    got = grouped_matmul(x, w, be, m_tile=m_tile, **tiles)
    if grouped_matmul.launches_by_instance[instance] != before + 1:
        raise AssertionError(f"K4 on {tuple(x.shape)} {x.dtype} x "
                             f"{tuple(w.shape)} {w.dtype}, m_tile {m_tile}: "
                             f"not launched as {instance}")
    return got


def k4_float_case(torch, label, instance, x, w, be, mt, **tiles):
    """K4 and the plain version each within (K+1) u (|x| @ |w|) of the
    fp64 product; returns (max |K4 - plain|, max error of K4 / bound)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
    K = x.shape[1]
    got = k4_on(torch, instance, x, w, be, mt, **tiles)
    plain = grouped_matmul_plain(x, w, be, mt)
    want, mag = gmm_oracle(torch, x, w, be, mt)
    bound = (K + 1) * U * mag
    check_close(f"K4 {label} vs fp64", got, want, bound)
    check_close(f"plain {label} vs fp64", plain, want, bound)
    share = float(((got.double() - want).abs() / bound.clamp_min(1e-300))
                  .max())
    return float((got - plain).abs().max()), share


def phase_k4_cases(torch, dev, arch="dbrx-132b", n_blocks=(144, 20)):
    """K4 against its plain version on edge cases, each asserting the
    instance that ran it. The simt instance: an expert with no rows, a
    single expert, trailing clipped blocks, m_tile 8/16/128/160, K and N
    not multiples of 4, every combination of fp32 and bf16 x and w. The
    wgmma instance (bf16 x and w): the same block structures at m_tile
    64/128/192/256, K 512 and 520 (a ragged last K tile), N 256 and 264 (a
    ragged last column tile), and NaN/Inf in the weights of the experts
    beside the one multiplied. Integer inputs exact; float inputs with K4
    and the plain version each within (K+1) u (|x| @ |w|) of the fp64
    product. Then K4 (wgmma) exact on the wi and wo products at ``arch``'s
    full width, integers |x|, |w| <= 2, bf16, for each of ``n_blocks``
    balanced row blocks (every sum stays below 4 K <= 2**24). Returns max
    |K4 - plain| over the float cases."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
    gen = torch.Generator(device=dev).manual_seed(11)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst, n_cases, share = 0.0, 0, 0.0
    for case in K4_CASES:
        for xn, xd in dtypes.items():
            for wn, wd in dtypes.items():
                K, N = 99, 301
                x, w, be, mt = k4_case(torch, dev, gen, case, K, N, xd, wd,
                                       True)
                got = k4_on(torch, "simt", x, w, be, mt, k_tile=K, n_tile=N)
                if not torch.equal(got, grouped_matmul_plain(x, w, be, mt)):
                    raise AssertionError(f"K4 {case} x {xn} w {wn}: differs "
                                         f"from its plain version on integer "
                                         f"inputs")
                K, N = 512, 258
                x, w, be, mt = k4_case(torch, dev, gen, case, K, N, xd, wd,
                                       False)
                err, sh = k4_float_case(torch, f"{case} x {xn} w {wn}",
                                        "simt", x, w, be, mt, n_tile=N)
                worst, share = max(worst, err), max(share, sh)
                n_cases += 2
    log(f"K4 simt == plain on {n_cases // 2} integer cases; {n_cases // 2} "
        f"float cases within (K+1) u (|x| @ |w|) of fp64 (at most "
        f"{share:.4f} of it), max |K4 - plain| {worst:.3e}")
    bf = torch.bfloat16
    n_int = n_float = 0
    share = 0.0
    for case, (blocks, trailing) in K4_WGMMA_CASES.items():
        for mt in (64, 128, 192, 256):
            for K, N in ((512, 256), (520, 264)):
                label = f"wgmma {case} m_tile {mt} K {K} N {N}"
                x, w, be, _ = k4_blocks(torch, dev, gen, blocks, trailing, mt,
                                        K, N, bf, bf, True)
                got = k4_on(torch, "wgmma", x, w, be, mt, k_tile=K, n_tile=N)
                if not torch.equal(got, grouped_matmul_plain(x, w, be, mt)):
                    raise AssertionError(f"K4 {label}: differs from its "
                                         f"plain version on integer inputs")
                x, w, be, _ = k4_blocks(torch, dev, gen, blocks, trailing, mt,
                                        K, N, bf, bf, False)
                err, sh = k4_float_case(torch, label, "wgmma", x, w, be, mt,
                                        k_tile=K, n_tile=N)
                worst, share = max(worst, err), max(share, sh)
                n_int, n_float = n_int + 1, n_float + 1
    for mt in (64, 128):
        for poison in (float("nan"), float("inf")):
            x, w, be, _ = k4_blocks(torch, dev, gen, [0, 3, 0], 0, mt, 520,
                                    264, bf, bf, True)
            w[0] = poison
            w[2] = poison
            got = k4_on(torch, "wgmma", x, w, be, mt, k_tile=520, n_tile=264)
            if not (bool(torch.isfinite(got).all())
                    and torch.equal(got, x.float() @ w[1].float())):
                raise AssertionError(f"K4 wgmma, m_tile {mt}: {poison} in "
                                     f"the weights of experts 0 and 2 "
                                     f"reached expert 1's product")
            n_int += 1
    log(f"K4 wgmma == plain on {n_int} integer cases (4 with NaN/Inf in the "
        f"neighbouring experts' weights); {n_float} float cases within "
        f"(K+1) u (|x| @ |w|) of fp64 (at most {share:.4f} of it); max "
        f"|K4 - plain| over all float cases {worst:.3e}")

    cfg = get_config(arch)
    E, D, FF = cfg.n_experts, cfg.d_model, cfg.d_ff
    for prod, K, N in (("wi", D, FF), ("wo", FF, D)):
        w = torch.randint(-2, 3, (E, K, N), generator=gen,
                          device=dev).to(torch.bfloat16)
        for nb in n_blocks:
            be = (torch.arange(nb, device=dev) * E // nb).to(torch.int32)
            x = torch.randint(-2, 3, (nb * 128, K), generator=gen,
                              device=dev).to(torch.bfloat16)
            got = k4_on(torch, "wgmma", x, w, be, 128)
            want = grouped_matmul_plain(x, w, be)
            if not torch.equal(got, want):
                raise AssertionError(f"K4 at {arch}'s {prod} width "
                                     f"({nb * 128} x {K} @ {E} x {K} x {N},"
                                     f" integers) is not exact")
            log(f"K4 wgmma exact at {arch}'s {prod} width on integers: "
                f"{nb * 128} x {K} @ [{E}, {K}, {N}] bf16, max |out| "
                f"{float(want.abs().max()):.0f}")
            del got, want, x
        del w
    return worst


def dispatched_rows(torch, x, meta):
    """x's (token, slot) rows in moe_block's padded, expert-sorted order:
    the operand of its first two grouped GEMMs."""
    D = x.shape[-1]
    k = meta["ids"].shape[1]
    xs = torch.zeros((meta["M"], D), dtype=x.dtype, device=x.device)
    xs[meta["dst"]] = x.reshape(-1, D)[meta["order"] // k]
    return xs


def k4_pair_check(torch, label, a, w, be, m_tile):
    """K4 against its plain version on the same operands. Each is an fp32
    sum of K products within (K+1) u (|a| @ |w|) of the exact product
    (bf16 x bf16 products are exact in fp32; an fp32 product rounds once),
    so the two differ by at most twice that. |a| @ |w| is itself taken by
    the plain version, an fp32 sum of non-negative terms low by at most a
    factor 1 - (K+1) u, which the bound divides out. Returns (K4's output,
    max |K4 - plain|)."""
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_plain)
    K = a.shape[1]
    got = grouped_matmul(a, w, be, m_tile=m_tile)
    plain = grouped_matmul_plain(a, w, be, m_tile)
    mag = grouped_matmul_plain(a.abs(), w.abs(), be, m_tile)
    bound = mag.double() * (2 * (K + 1) * U / (1 - (K + 1) * U))
    del mag
    err = check_close(label, got, plain, bound)
    return got, err


def moe_oracle(torch, p, x, y, ids, route_w, idx):
    """Hold moe_block's output rows ``y[idx]`` against an fp64 oracle
    computed per expert from the same operands (x, the expert weights and
    the router's ids and weights of this run). Returns (max abs error, max
    error / bound).

    The bound, per token and output column, follows the port's dtype flow
    with u the unit roundoff of x's dtype (2**-8 bf16, 2**-24 fp32) and
    v = 2**-24:
      h = x.Wi, g = x.Wg: fp32 sums of D products, then rounded to x's
        dtype:  eh = u|h| + (1+u)(D+1) v (|x|.|Wi|), eg likewise;
      s = silu(g) in fp32 of the rounded g (|silu'| <= 1.1), rounded:
        es = 1.1 eg + (u + 4v)(|s| + 1.1 eg);
      a = s h rounded once:  ea = ep + u(|a| + ep),
        ep = es(|h| + eh) + |s| eh;
      y = a.Wo, an fp32 sum of FF products of the rounded a:
        ey = (ea + (FF+1) v (|a| + ea)) . |Wo|;
      the combine, k fp32 products by the router weights p_j >= 0 summed
      in fp32: eo = sum_j p_j ey_j + (k+1) v sum_j p_j (|y_j| + ey_j);
      the cast of the combine to x's dtype:  eo + u(|out| + eo).
    Every step is the worst case of a rounding or of a sum, so the bound
    holds for any summation order; it is loose by about sqrt(FF) for
    random data, and the ratio it logs shows how loose."""
    v = U
    u = 2.0 ** -8 if x.dtype == torch.bfloat16 else U
    D = x.shape[-1]
    FF = p["wi"].shape[2]
    k = ids.shape[1]
    xt = x.reshape(-1, D)[idx].double()
    ids_s, pw = ids[idx], route_w[idx].double()
    want = torch.zeros((len(idx), D), dtype=torch.float64, device=x.device)
    err = torch.zeros_like(want)
    mag = torch.zeros_like(want)
    for e in torch.unique(ids_s).tolist():
        t_j = (ids_s == e).nonzero()
        rows, slot = t_j[:, 0], t_j[:, 1]
        xe = xt[rows]
        wi, wg, wo = (p[n][e].double() for n in ("wi", "wg", "wo"))
        h, g = xe @ wi, xe @ wg
        eh = u * h.abs() + (1 + u) * (D + 1) * v * (xe.abs() @ wi.abs())
        eg = u * g.abs() + (1 + u) * (D + 1) * v * (xe.abs() @ wg.abs())
        del wi, wg
        s = torch.nn.functional.silu(g)
        es = 1.1 * eg + (u + 4 * v) * (s.abs() + 1.1 * eg)
        a = s * h
        ep = es * (h.abs() + eh) + s.abs() * eh
        ea = ep + u * (a.abs() + ep)
        ye = a @ wo
        ey = (ea + (FF + 1) * v * (a.abs() + ea)) @ wo.abs()
        pj = pw[rows, slot][:, None]
        want.index_add_(0, rows, pj * ye)
        err.index_add_(0, rows, pj * ey)
        mag.index_add_(0, rows, pj * (ye.abs() + ey))
    eo = err + (k + 1) * v * mag
    bound = eo + u * (want.abs() + eo)
    got = y.reshape(-1, D)[idx]
    max_err = check_close("moe_block vs fp64 oracle", got, want, bound)
    ratio = float(((got.double() - want).abs() / bound).max())
    return max_err, ratio


def phase_moe(torch, dev, arch="dbrx-132b", tokens=((4, 1024), (128, 1)),
              skew=8.0, sample=256):
    """Slice C1's main path: ``moe_block`` at ``arch``'s full width through
    K4. Weights from ``init_moe`` with a seeded generator on the card
    (router fp32, experts bf16); x bf16 [B, T, D] from a seed for each
    token shape, with balanced and skewed routing (+``skew`` on the router
    column of expert 0, as examples/moe_block_dispatch.py does); then one
    fp32 run (fp32 weights and x) at the first token shape, balanced. The
    K4 launches of these five calls are the path's count: 3 per call. Then
    in each case the dispatch is rebuilt from the router (``block_dispatch``
    with moe_block's default m_tile) and each of the three products (wi,
    wg, then wo on the gated h) is held against the plain version on the
    same operands (``k4_pair_check``); the outputs of K4's path and of the
    twin (use_pallas=False) are held against an fp64 oracle over a seeded
    sample of ``sample`` tokens. Returns what the timing phase needs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.models.moe import (_route, block_dispatch, init_moe,
                                        moe_block)
    m_tile = 128                           # moe_block's default
    cfg = get_config(arch)
    D, FF, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    kw = dict(top_k=k, n_experts=E)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_moe(gen, D, FF, E, device=dev)
    p32 = init_moe(gen, D, FF, E, dtype=torch.float32, device=dev)
    bias = torch.zeros(E, device=dev)
    bias[0] = skew
    routers = {"balanced": p, "skewed": dict(p, router=p["router"] + bias)}
    xgen = torch.Generator(device=dev).manual_seed(1)
    xs = {bt: torch.randn((*bt, D), generator=xgen, device=dev).to(
        torch.bfloat16) for bt in tokens}
    x32 = torch.randn((*tokens[0], D), generator=xgen, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"{arch}: d_model={D} d_ff={FF} {E} experts top-{k}; expert weights "
        f"{sum(p[n].numel() for n in ('wi', 'wg', 'wo')) * 2 / 1e9:.2f} GB "
        f"bf16 and {sum(p32[n].numel() for n in ('wi', 'wg', 'wo')) * 4 / 1e9:.2f}"
        f" GB fp32, drawn in {time.perf_counter() - t0:.1f}s")

    runs = [(f"{bt[0] * bt[1]} tokens {name}", routers[name], xs[bt])
            for bt in tokens for name in ("balanced", "skewed")]
    runs.append((f"{tokens[0][0] * tokens[0][1]} tokens balanced fp32", p32,
                 x32))
    grouped_matmul.launches = 0            # main path starts here
    grouped_matmul.launches_by_instance = {"wgmma": 0, "simt": 0}
    t_main = time.perf_counter()
    outs = []
    for label, params, x in runs:
        before = grouped_matmul.launches
        y, aux = moe_block(params, x, **kw)
        outs.append((y, aux, grouped_matmul.launches - before))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = grouped_matmul.launches     # main path ends here
    by_instance = dict(grouped_matmul.launches_by_instance)
    per_call = [n for _, _, n in outs]
    log(f"moe_block main path: {len(runs)} calls in {t_main:.2f}s, K4 "
        f"launches {launches} ({per_call} per call; by instance "
        f"{by_instance})")
    if launches != 3 * len(runs) or any(n != 3 for n in per_call):
        raise AssertionError(f"K4 launches {per_call} per moe_block call, "
                             f"want 3 each")
    # every bf16 call runs on the tensor cores, the fp32 one on the CUDA
    # cores
    want = {"wgmma": 3 * (len(runs) - 1), "simt": 3}
    if by_instance != want:
        raise AssertionError(f"K4 launches by instance {by_instance}, want "
                             f"{want}")

    sgen = torch.Generator().manual_seed(2)
    metas = []
    for (label, params, x), (y, aux, _) in zip(runs, outs):
        n_tok = x.shape[0] * x.shape[1]
        if tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype or \
                not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{label}: output {tuple(y.shape)} "
                                 f"{y.dtype} not finite or of x's shape")
        route_w, ids, _ = _route(params, x.reshape(-1, D), k, True)
        meta = block_dispatch(ids, E, m_tile)
        metas.append(meta)
        be = meta["block_expert"]
        xs_r = dispatched_rows(torch, x, meta)
        h, err_i = k4_pair_check(torch, f"{label}: K4 wi vs plain", xs_r,
                                 params["wi"], be, m_tile)
        g, err_g = k4_pair_check(torch, f"{label}: K4 wg vs plain", xs_r,
                                 params["wg"], be, m_tile)
        del xs_r
        h, g = h.to(x.dtype), g.to(x.dtype)
        h = torch.nn.functional.silu(g.float()).to(x.dtype) * h
        del g
        _, err_o = k4_pair_check(torch, f"{label}: K4 wo vs plain", h,
                                 params["wo"], be, m_tile)
        del h
        y_t, _ = moe_block(params, x, use_pallas=False, **kw)
        idx = torch.randperm(n_tok, generator=sgen)[:sample].to(dev)
        err, ratio = moe_oracle(torch, params, x, y, ids, route_w, idx)
        err_t, ratio_t = moe_oracle(torch, params, x, y_t, ids, route_w, idx)
        counts = meta["counts"].double()
        live = int((-(-meta["counts"] // m_tile)).sum())
        log(f"{label}: loads max/mean {float(counts.max() / counts.mean()):.2f}"
            f" (min {int(counts.min())}, max {int(counts.max())}), "
            f"{be.numel()} blocks ({live} live), aux {float(aux):.4f}; max "
            f"|K4 - plain| wi {err_i:.3e} wg {err_g:.3e} wo {err_o:.3e}; vs "
            f"fp64 oracle on {len(idx)} tokens: K4 max err {err:.3e} "
            f"({ratio:.4f} of the bound), twin {err_t:.3e} ({ratio_t:.4f}); "
            f"max |K4 path - twin| "
            f"{float((y.float() - y_t.float()).abs().max()):.3e}")
        del y_t
    # the balanced runs' dispatch at each token shape, for the timing phase
    return p, p32, xs, x32, metas[0:2 * len(tokens):2], launches


def gmm_bound(M, K, N, n_used, x_bytes, w_bytes, peak, nb):
    """The least time the card could take for one grouped GEMM: its flops
    (padding rows included: K4 multiplies them) over ``peak``, or its
    bytes (x, the weights of the experts used, the fp32 output and the
    block ids, each once) over the memory rate."""
    flops = 2.0 * M * K * N
    moved = M * K * x_bytes + n_used * K * N * w_bytes + M * N * 4 + nb * 4
    ops_ms, bytes_ms = flops / peak * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, moved)


def k4_c_launch(torch, lib, instance, a, w, be, m_tile):
    """K4 through its C interface with the instance (0 simt, 1 wgmma)
    chosen here; the wrapper picks it from the operands. Not counted as a
    launch of the main path."""
    M, K = a.shape
    E, _, N = w.shape
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = lib.grouped_matmul_launch(
        a.data_ptr(), w.data_ptr(), be.data_ptr(), out.data_ptr(),
        int(a.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), E,
        M // m_tile, m_tile, K, N, instance,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch (instance {instance}) failed: "
                           f"{lib.grouped_matmul_error_string(err).decode()}")
    return out


def phase_timing_k4(torch, p, p32, xs_by_shape, x32, metas, launches,
                    float_err, reps=10, reps_f32=3):
    """K4 at the token shapes of phase_moe (balanced). At the first (the
    prefill chunk): each of the three GEMMs in bf16 (wgmma), the wi product
    through the simt instance on the same bf16 operands and with fp32
    operands, the plain version of wi, and torch._grouped_mm (bf16 in and
    out; a yardstick the port never calls). Every timed wi output is held
    against the plain version within the pair bound of k4_pair_check. At
    the second (a decode step): the three GEMMs beside their bound. Then
    the whole moe_block at every token shape. K4 is timed through the
    entry moe_block uses, which skips the public wrapper's expert-id range
    check and its device sync."""
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul_in_range as grouped_matmul, grouped_matmul_plain,
        load_grouped_matmul)
    from repro_torch.models.moe import moe_block
    lib = load_grouped_matmul()
    shapes = list(xs_by_shape)
    x = xs_by_shape[shapes[0]]
    meta = metas[0]
    D = x.shape[-1]
    E, _, FF = p["wi"].shape
    k = meta["ids"].shape[1]
    be, M = meta["block_expert"], meta["M"]
    m_tile = M // be.numel()
    xs = dispatched_rows(torch, x, meta)
    xs32 = dispatched_rows(torch, x32, meta)
    plain = grouped_matmul_plain(xs, p["wi"], be, m_tile)
    pair = grouped_matmul_plain(xs.abs(), p["wi"].abs(), be, m_tile).double()
    pair *= 2 * (D + 1) * U / (1 - (D + 1) * U)
    held = {}

    def hold(label, got):
        check_close(f"K4 {label} vs plain", got, plain, pair)
        held[label] = float(((got.double() - plain).abs()
                             / pair.clamp_min(1e-300)).max())

    h = grouped_matmul(xs, p["wi"], be).to(x.dtype)
    g = grouped_matmul(xs, p["wg"], be).to(x.dtype)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * h
    del g
    n_used = int((meta["counts"] > 0).sum())
    gemms = {"wi": (xs, p["wi"]), "wg": (xs, p["wg"]), "wo": (h, p["wo"])}
    ms = {}
    for name, (a, w) in gemms.items():
        grouped_matmul(a, w, be)
        ms[name] = cuda_ms(lambda a=a, w=w: grouped_matmul(a, w, be), reps)
    hold("wi wgmma", grouped_matmul(xs, p["wi"], be))
    simt = lambda: k4_c_launch(torch, lib, 0, xs, p["wi"], be,  # noqa: E731
                               m_tile)
    hold("wi simt", simt())
    ms["wi simt"] = cuda_ms(simt, reps_f32)
    grouped_matmul(xs32, p32["wi"], be)
    ms["wi fp32"] = cuda_ms(lambda: grouped_matmul(xs32, p32["wi"], be),
                            reps_f32)
    ms["wi again"] = cuda_ms(lambda: grouped_matmul(xs, p["wi"], be), reps)
    ms["plain"] = cuda_ms(
        lambda: grouped_matmul_plain(xs, p["wi"], be, m_tile), 3)
    del plain, pair
    offs = torch.cumsum(-(-meta["counts"] // m_tile) * m_tile, 0).to(
        torch.int32)
    if hasattr(torch, "_grouped_mm"):
        lib_mm = lambda: torch._grouped_mm(  # noqa: E731
            xs, p["wi"], offs=offs)
        got, ref = lib_mm(), grouped_matmul(xs, p["wi"], be)
        rows = int(offs[-1])
        lib_err = float((got[:rows].float() - ref[:rows]).abs().max()
                        / ref[:rows].abs().max())
        del got, ref
        library_ms = cuda_ms(lib_mm, reps)
        log(f"torch._grouped_mm (bf16 output, the {rows} rows the experts "
            f"cover; the {M - rows} trailing rows skipped): {library_ms:.3f}"
            f" ms, max |lib - K4| / max|K4| {lib_err:.2e}")
    else:
        library_ms = None
        log(f"torch {torch.__version__} has no torch._grouped_mm: "
            f"library_ms is null")
    bounds = {}
    for name, (a, w) in gemms.items():
        K, N = w.shape[1], w.shape[2]
        bounds[name] = gmm_bound(M, K, N, n_used, 2, 2, BF16_FLOPS,
                                 be.numel())
    bounds["wi simt"] = bounds["wi"]
    bounds["wi fp32"] = gmm_bound(M, D, FF, n_used, 4, 4, FP32_FLOPS,
                                  be.numel())
    for name, (b_ms, b_by, flops, moved) in bounds.items():
        log(f"K4 {name} at {M} rows: {ms[name]:.3f} ms, "
            f"{flops / ms[name] / 1e9:.2f} TFLOP/s; bound {b_ms:.3f} ms by "
            f"{b_by} ({flops / 1e12:.3f} TFLOP, {moved / 1e9:.3f} GB); "
            f"{b_ms / ms[name] * 100:.2f}% of the bound")
    log("K4 wi, max |K4 - plain| as a share of the pair bound: " + ", ".join(
        f"{label} {share:.3e}" for label, share in held.items()))
    log(f"K4 wi again {ms['wi again']:.3f} ms; wgmma "
        f"{ms['wi simt'] / ms['wi']:.1f}x faster than simt on the same bf16 "
        f"operands; plain version of wi (fp32 cuBLAS per expert run) "
        f"{ms['plain']:.3f} ms")
    del xs, xs32, h

    for bt, meta_d in zip(shapes[1:], metas[1:]):
        xd = xs_by_shape[bt]
        be_d, M_d = meta_d["block_expert"], meta_d["M"]
        a_d = dispatched_rows(torch, xd, meta_d)
        h_d = grouped_matmul(a_d, p["wi"], be_d).to(xd.dtype)
        g_d = grouped_matmul(a_d, p["wg"], be_d).to(xd.dtype)
        h_d = torch.nn.functional.silu(g_d.float()).to(xd.dtype) * h_d
        del g_d
        used = int((meta_d["counts"] > 0).sum())
        live = int((-(-meta_d["counts"] // m_tile)).sum())
        for name, a in (("wi", a_d), ("wg", a_d), ("wo", h_d)):
            w = p[name]
            grouped_matmul(a, w, be_d)
            t = cuda_ms(lambda a=a, w=w: grouped_matmul(a, w, be_d), reps)
            b_ms, b_by, fl, moved = gmm_bound(M_d, w.shape[1], w.shape[2],
                                              used, 2, 2, BF16_FLOPS,
                                              be_d.numel())
            log(f"K4 {name} at {bt[0] * bt[1]} tokens ({M_d} rows, "
                f"{be_d.numel()} blocks, {live} live, {used} experts): "
                f"{t:.3f} ms, {fl / t / 1e9:.2f} TFLOP/s, "
                f"{moved / t / 1e9:.3f} TB/s; bound {b_ms:.3f} ms by {b_by} "
                f"({moved / 1e9:.3f} GB); {b_ms / t * 100:.2f}% of the bound")
        del a_d, h_d
    for bt in shapes:
        xb = xs_by_shape[bt]
        moe_block(p, xb, top_k=k, n_experts=E)
        t = cuda_ms(lambda xb=xb: moe_block(p, xb, top_k=k, n_experts=E),
                    reps)
        log(f"whole moe_block at {bt[0] * bt[1]} tokens (balanced): "
            f"{t:.3f} ms; reading the {E} experts' bf16 weights once takes "
            f"{3 * p['wi'].numel() * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms at "
            f"the memory rate")
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:33",
            "launches": launches, "max_abs_err": float_err,
            "ms": ms["wi"], "plain_ms": ms["plain"],
            "bound_ms": bounds["wi"][0], "bound_by": bounds["wi"][1],
            "library_ms": library_ms}


# ------------------------------------------------------------ slice F
FLEET_SLOTS = 4            # slots on one card when only one is visible
FLEET_INT_WIDTHS = (2048, 256)
ZIPF_NODES = (20_000, 27_500, 35_000, 42_500, 50_000)
ZIPF_REQUESTS = 96
ZIPF_F = 256
FLEET_HEDGE_MS = 0.2


def fleet_slots(torch):
    """One slot per card where several are visible, else FLEET_SLOTS slots
    of the one card."""
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * FLEET_SLOTS


def integer_copy(g, seed):
    """``g``'s structure with values 1-2: with features in -2..2 every
    partial sum of the Reddit analogue (max degree ~2.07M) stays below
    2**24, so every sum is exact in any order."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph
    vals = np.random.default_rng(seed).integers(1, 3, g.nnz)
    return CSRGraph(g.rowptr, g.colidx, vals.astype(np.float32), g.n_cols)


def int_features(torch, n, F, gen, dev):
    return torch.randint(-2, 3, (n, F), generator=gen, device=dev).float()


def kernel_counters():
    from repro_torch.kernels.spmm_accel import (spmm_block_slabs,
                                                spmm_block_slabs_windowed)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    return {"K1": spmm_block_slabs, "K2": spmm_block_slabs_windowed,
            "K3": spmm_block_slabs_hbm}


def reset_launches():
    from repro_torch.kernels.spmm_accel import GATHER_INSTANCES
    for fn in kernel_counters().values():
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)


def read_launches():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def slot_routed(stats):
    """The engine's per-slot routed counts, by kernel."""
    return {"K1": stats["slot_routed_resident"],
            "K2": stats["slot_routed_windowed"],
            "K3": stats["slot_routed_hbm"]}


def fleet_serve_layers(torch, fleet, graphs, weights, feats, slots,
                       nnz_chunk, label):
    """Serve the GCN layer by layer, each graph in a dispatch of its own,
    so each dispatch's FleetDecision and block counts can be read after
    it. Every answer is held against the CSR oracle within the summation
    bound, plus the slot count where split rows sum across slots and the
    window count where a share ran K2. Returns the strategies seen."""
    import dataclasses
    from repro_torch.distributed import round_robin_block_order
    from repro_torch.kernels.router import route_fleet
    C = fleet.config.deg_bound
    seen = {}
    h = dict(feats)
    for li, w in enumerate(weights):
        for name, g in graphs.items():
            xw = h[name] @ w
            plan = fleet.plan_for(name)
            F = int(xw.shape[1])
            fd = route_fleet(plan.n_cols, F, int(plan.slabs["C"]),
                             int(plan.slabs["R"]), plan.num_blocks,
                             len(slots))
            n_before = fleet.stats()["batches_dispatched"]
            t0 = time.perf_counter()
            y = fleet.serve_one(name, xw)
            ms = (time.perf_counter() - t0) * 1e3
            if fd.strategy == "single":
                dec = fleet.last_decision       # None under accel: K1
                counts = ""
            else:
                # under accel every slot runs K1, under auto what the
                # router names for the slot's share
                dec = fd.per_device if fleet.backend == "auto" else None
                got = fleet.last_fleet_decision
                if dataclasses.asdict(got) != dataclasses.asdict(fd):
                    raise AssertionError(f"{label} {name}: the engine routed "
                                         f"{got.describe()}, route_fleet "
                                         f"says {fd.describe()}")
                counts = ""
                if fd.strategy == "block":
                    _, live = round_robin_block_order(plan.num_blocks,
                                                      len(slots))
                    blocks = fleet.last_block_counts
                    if blocks != [int(c) for c in live] or \
                            max(blocks) - min(blocks) > 1:
                        raise AssertionError(f"{label} {name}: block counts "
                                             f"{blocks}")
                    counts = f", live blocks per slot {blocks}"
            if fleet.stats()["batches_dispatched"] != n_before + 1:
                raise AssertionError(f"{label} {name}: not one dispatch")
            regime = dec.backend if dec is not None else "resident"
            extra = (len(slots) if fd.strategy == "block" else 0) + (
                dec.num_windows if regime == "windowed" else 0)
            err = csr_check(torch, g, xw, y, C, nnz_chunk, extra)
            seen.setdefault(fd.strategy, 0)
            seen[fd.strategy] += 1
            if li == 0 or F != int(weights[li - 1].shape[1]):
                log(f"{label} layer {li} {name} F={F}: {fd.describe()}; "
                    f"slot regime {regime}{counts}; max err {err:.2e}; "
                    f"{ms:.1f} ms")
            h[name] = torch.relu(y) if li < len(weights) - 1 else y
    for name, g in graphs.items():
        if not bool(torch.isfinite(h[name]).all()) or \
                tuple(h[name].shape) != (g.n_rows, N_CLASSES):
            raise AssertionError(f"{label} {name}: logits not finite or of "
                                 f"shape {tuple(h[name].shape)}")
    return seen


def fleet_serve_integers(torch, fleet, ints, dev, nnz_chunk, label):
    """The integer copies at each width of FLEET_INT_WIDTHS: exact."""
    gen = torch.Generator(device=dev).manual_seed(21)
    for F in FLEET_INT_WIDTHS:
        for name, g in ints.items():
            x = int_features(torch, g.n_cols, F, gen, dev)
            y = fleet.serve_one(name, x)
            if not torch.equal(y.double(), csr_oracle(torch, g, x,
                                                      nnz_chunk)):
                raise AssertionError(f"{label} {name} F={F}: not exact")
    log(f"{label}: integer copies {sorted(ints)} exact at F="
        f"{list(FLEET_INT_WIDTHS)}")


def zipf_mix(torch, dev, nodes, requests):
    """The reference's zipf mix: an integer power-law graph of 8 edges per
    node for each entry of ``nodes`` (values 1-2), integer features of
    width ZIPF_F, and a schedule of ``requests`` graph ids drawn with
    probability ~ rank**-1.6."""
    import numpy as np
    from repro_torch.data.graphs import make_power_law_graph
    graphs = {f"z{i}": integer_copy(make_power_law_graph(n, 8 * n,
                                                         seed=50 + i), 60 + i)
              for i, n in enumerate(nodes)}
    gen = torch.Generator(device=dev).manual_seed(23)
    feats = {k: int_features(torch, g.n_cols, ZIPF_F, gen, dev)
             for k, g in graphs.items()}
    names = list(graphs)
    rng = np.random.default_rng(3)
    p = np.arange(1, len(names) + 1, dtype=np.float64) ** -1.6
    p /= p.sum()
    schedule = [names[i] for i in rng.choice(len(names), size=requests, p=p)]
    return graphs, feats, schedule


def zipf_pass(e, schedule, feats):
    """Submit ``schedule`` to ``e`` from 4 threads (thread t takes every
    4th request from the t-th) and return (graph id, answer) pairs, thread
    by thread."""
    futs = [[] for _ in range(4)]

    def sub(t):
        futs[t] = [e.submit(gid, feats[gid]) for gid in schedule[t::4]]
    ths = [threading.Thread(target=sub, args=(t,)) for t in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a zipf submitter did not finish")
    return [(gid, f.result(timeout=600))
            for t, fs in enumerate(futs)
            for gid, f in zip(schedule[t::4], fs)]


ZIPF_ENGINE = dict(max_batch_requests=32, max_wait_ms=3.0,
                   max_graphs_per_batch=1, backend="accel")
ZIPF_REPLICATION = dict(rate_per_replica=1.0, max_replicas=8,
                        replica_halflife_s=4.0, replication_interval_s=0.005,
                        split_min_requests=1)


def fleet_zipf(torch, dev, slots, nnz_chunk):
    """Phase 15(c): the reference's zipf script at 20k-50k nodes and F=256
    (integer graphs), replication on and off. Returns both engines' stats,
    the hottest graph and its features."""
    from repro_torch.serve.fleet import FleetGraphEngine
    graphs, feats, schedule = zipf_mix(torch, dev, ZIPF_NODES, ZIPF_REQUESTS)
    runs = {}
    engines = {}
    for mode, kw in (("on", ZIPF_REPLICATION),
                     ("off", dict(replicate_hot=False))):
        e = FleetGraphEngine(devices=slots, **ZIPF_ENGINE, **kw)
        for k, g in graphs.items():
            e.register_graph(k, g)
        zipf_pass(e, schedule, feats)       # warm: learn rates, replicate
        e.reset_stats()
        t0 = time.perf_counter()
        outs = zipf_pass(e, schedule, feats)
        wall = time.perf_counter() - t0
        runs[mode] = (outs, e.stats(), wall)
        engines[mode] = e
    oracle = {k: csr_oracle(torch, g, feats[k], nnz_chunk)
              for k, g in graphs.items()}
    for (ga, a), (gb, b) in zip(runs["on"][0], runs["off"][0]):
        if ga != gb or not torch.equal(a, b) or \
                not torch.equal(a.double(), oracle[ga]):
            raise AssertionError(f"zipf {ga}: replicated answer differs")
    on, off = runs["on"][1], runs["off"][1]
    for mode, (_, st, wall) in runs.items():
        log(f"zipf replication {mode}: {ZIPF_REQUESTS} requests in "
            f"{wall * 1e3:.1f} ms; per-slot requests "
            f"{st['fleet_device_requests']}, dispatches "
            f"{st['fleet_device_dispatches']}, feature/block sharded "
            f"{st['fleet_feature_sharded']}/{st['fleet_block_sharded']}; "
            f"occupancy {st['fleet_occupancy']:.3f}; promotions "
            f"{st['fleet_promotions']}, replicated keys "
            f"{st['cache_replicated_keys']}, replica copies "
            f"{st['cache_replica_copies']}; busy s "
            + ", ".join(f"{v:.4f}" for v in st["fleet_device_busy_s"]))
    used = {m: sum(1 for r in runs[m][1]["fleet_device_requests"] if r > 0)
            for m in runs}
    if on["fleet_promotions"] < 1 or on["cache_replica_copies"] < 1 \
            or used["on"] <= used["off"]:
        raise AssertionError(f"zipf replication: promotions "
                             f"{on['fleet_promotions']}, slots used {used}")
    for e in engines.values():
        e.close()
    hot = max(set(schedule), key=schedule.count)
    return [on, off], graphs[hot], feats[hot]


def fleet_mutate(torch, slots, g, x, nnz_chunk):
    """Phase 15(d): mutate() on a graph replicated to every slot while two
    threads read it; every read equals one published version's product,
    and the new version is staged on the primary and every replica. The
    engine replicates whatever it serves (``rate_per_replica`` 1e-6), so
    no replica is demoted during the race."""
    from repro_torch.serve.fleet import FleetGraphEngine
    e = FleetGraphEngine(devices=slots, backend="accel",
                         rate_per_replica=1e-6, max_replicas=len(slots))
    key = e.register_graph("hot", g).key
    primary = e.cache.device_index_of(key)
    extras = [m for m in range(len(slots)) if m != primary]
    for m in extras:
        if not e.cache.add_replica(key, m):
            raise AssertionError(f"could not replicate to slot {m}")
    deltas, chain = chain_deltas(g, 15, integer=True)
    C = e.config.deg_bound
    stop = threading.Event()
    reads, errors = [], []

    def reader():
        # two requests in flight per reader, so flushes hold groups of
        # several requests, which split over the replicas
        while not stop.is_set():
            try:
                futs = [e.submit("hot", x) for _ in range(2)]
                reads.extend(f.result(timeout=600) for f in futs)
            except BaseException as exc:  # noqa: BLE001 — raised below
                errors.append(exc)
                return
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for th in readers:
        th.start()
    t0 = time.perf_counter()
    for d in deltas:
        e.mutate("hot", d).result(timeout=600)
    t_mut = time.perf_counter() - t0
    stop.set()
    for th in readers:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a reader did not finish")
    if errors:
        raise errors[0]
    seen = [match_version(torch, chain, x, y, C, nnz_chunk, True)
            for y in reads]
    new_key = e.plan_for("hot").key
    held = e.cache.replica_devices(new_key)
    staged = [e.cache.plan_on(new_key, m) for m in held]
    if sorted(held) != list(range(len(slots))) or held[0] != primary or any(
            p is None or p.version != e.graph_version("hot")
            for p in staged):
        raise AssertionError(f"v{e.graph_version('hot')} held on {held}, "
                             f"expected every slot, primary {primary}")
    last = e.serve_one("hot", x)
    if not torch.equal(last.double(), csr_oracle(torch, chain[-1], x,
                                                 nnz_chunk)):
        raise AssertionError("final version not exact")
    st = e.stats()
    log(f"fleet mutate: {len(deltas)} deltas on a {g.n_rows}-node graph "
        f"held on slots {held} (primary first) in {t_mut:.2f}s; "
        f"{len(reads)} racing reads, each one version's exact product "
        f"(versions read {sorted(set(seen))}); version "
        f"{e.graph_version('hot')} staged on every replica; repairs "
        f"{st['plan_repairs']}, rebuilds {st['plan_rebuilds']}; per-slot "
        f"requests {st['fleet_device_requests']}, feature/block sharded "
        f"{st['fleet_feature_sharded']}/{st['fleet_block_sharded']}")
    e.close()
    return st


def fleet_hedge(torch, dev, slots, small, nnz_chunk):
    """Phase 15(e): hedged single-slot groups on small integer graphs
    replicated by hand (the engine keeps every replica: ``rate_per_replica``
    1e-6); answers exact, hedge counters logged."""
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.serve.fleet import FleetGraphEngine
    graphs = {"tiny": integer_copy(small["tiny"], 70)}
    for i, n in enumerate((3_000, 3_500)):
        graphs[f"h{i}"] = integer_copy(make_power_law_graph(n, 6 * n,
                                                            seed=80 + i),
                                       81 + i)
    e = FleetGraphEngine(devices=slots, backend="accel",
                         rate_per_replica=1e-6, max_replicas=3,
                         hedge_ms=FLEET_HEDGE_MS)
    gen = torch.Generator(device=dev).manual_seed(29)
    feats = {}
    for k, g in graphs.items():
        key = e.register_graph(k, g).key
        primary = e.cache.device_index_of(key)
        for m in range(1, min(3, len(slots))):
            e.cache.add_replica(key, (primary + m) % len(slots))
        feats[k] = int_features(torch, g.n_cols, ZIPF_F, gen, dev)
    oracle = {k: csr_oracle(torch, g, feats[k], nnz_chunk)
              for k, g in graphs.items()}
    for _ in range(8):
        for k in graphs:
            if not torch.equal(e.serve_one(k, feats[k]).double(), oracle[k]):
                raise AssertionError(f"hedged {k}: not exact")
    time.sleep(0.5)                 # let hedges still in flight finish
    st = e.stats()
    log(f"hedging (hedge_ms={FLEET_HEDGE_MS}): {st['requests_served']} "
        f"requests exact; hedged dispatches {st['fleet_hedged']}, hedge "
        f"wins {st['fleet_hedge_wins']}")
    e.close()
    return st


def fleet_layer_times(torch, fleet, single, g, reps=3):
    """Phase 15(f): one served layer of ``g`` ("Reddit") at F=2048 and
    F=256, the fleet against a single GraphServeEngine in turns; CUDA
    events on the caller's stream and the host clock, medians of
    ``reps``, and the fleet's busy clocks over its timed calls."""
    dev = fleet.device
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {}
    for F in (2048, 256):
        x = torch.randn((g.n_cols, F), generator=gen, device=dev)
        times = {"fleet": [], "single": []}
        for eng in (fleet, single):
            eng.serve_one("Reddit", x)          # warm
        fleet.reset_stats()
        for _ in range(reps):
            for label, eng in (("fleet", fleet), ("single", single),
                               ("single", single), ("fleet", fleet)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                eng.serve_one("Reddit", x)
                end.record()
                torch.cuda.synchronize()
                times[label].append((start.elapsed_time(end),
                                     (time.perf_counter() - t0) * 1e3))
        st = fleet.stats()
        n_fleet = len(times["fleet"])
        med = {k: (sorted(v)[len(v) // 2][0],
                   sorted(t for _, t in v)[len(v) // 2])
               for k, v in times.items()}
        busy = [b / n_fleet * 1e3 for b in st["fleet_device_busy_s"]]
        sharded = st["fleet_sharded_busy_s"] / n_fleet * 1e3
        strategy = ("feature" if st["fleet_feature_sharded"] else
                    "block" if st["fleet_block_sharded"] else "single")
        log(f"served Reddit layer F={F}: fleet ({strategy}, "
            f"{fleet.n_devices} slots) events {med['fleet'][0]:.3f} ms, "
            f"wall {med['fleet'][1]:.3f} ms; single GraphServeEngine events "
            f"{med['single'][0]:.3f} ms, wall {med['single'][1]:.3f} ms "
            f"(medians of {n_fleet}); fleet busy per call: sharded "
            f"{sharded:.3f} ms, per-slot "
            + ", ".join(f"{b:.3f}" for b in busy) + " ms")
        out[F] = {"fleet": med["fleet"], "single": med["single"],
                  "sharded_busy_ms": sharded}
    return out


def phase_fleet(torch, dev, graphs, small):
    """Phase 15, slice F: fleet serving over the slots of fleet_slots()."""
    from repro_torch.models.layers import dense_init
    from repro_torch.serve.fleet import FleetGraphEngine
    from repro_torch.serve.graph_engine import GraphServeEngine
    t_phase = time.perf_counter()
    slots = fleet_slots(torch)
    every = dict(graphs, **small)
    ints = {f"{k}#int": integer_copy(g, 40 + i)
            for i, (k, g) in enumerate(every.items())}
    gen = torch.Generator().manual_seed(0)
    dims = DIMS + [N_CLASSES]
    weights = [dense_init(gen, a, b, torch.float32, device=dev)
               for a, b in zip(dims[:-1], dims[1:])]
    dgen = torch.Generator(device=dev).manual_seed(17)
    feats = {name: torch.randn((g.n_rows, dims[0]), generator=dgen,
                               device=dev) for name, g in every.items()}
    nnz_chunk = 1 << 17
    log(f"fleet slots: {[str(s) for s in slots]}")

    fleet = FleetGraphEngine(devices=slots, backend="accel")
    t0 = time.perf_counter()
    for name, g in dict(every, **ints).items():
        fleet.register_graph(name, g)
    cs = fleet.cache.stats()
    log(f"fleet: {len(every) + len(ints)} plans placed in "
        f"{time.perf_counter() - t0:.1f}s, shard sizes "
        f"{cs['shard_sizes']}")
    paths = {}
    reset_launches()                        # the fleet path starts here
    # (a) accel: K1 on every slot
    seen = fleet_serve_layers(torch, fleet, every, weights, feats, slots,
                              nnz_chunk, "fleet accel")
    fleet_serve_integers(torch, fleet, ints, dev, nnz_chunk, "fleet accel")
    if set(seen) != {"feature", "block", "single"}:
        raise AssertionError(f"fleet strategies seen {seen}")
    st_a = fleet.stats()
    got = read_launches()
    log(f"(a) accel: dispatches by strategy {seen}; launches {got}, "
        f"per-slot routed {slot_routed(st_a)}")
    if got != slot_routed(st_a) or got["K1"] < 1:
        raise AssertionError(f"fleet accel launches {got} != per-slot "
                             f"routed {slot_routed(st_a)}")
    # (b) auto: each share on the kernel its shape routes to
    routed = FleetGraphEngine(devices=slots, backend="auto",
                              cache=fleet.cache)
    for name, g in dict(every, **ints).items():
        routed.register_graph(name, g)
    reset_launches()
    seen_b = fleet_serve_layers(torch, routed, every, weights, feats, slots,
                                nnz_chunk, "fleet auto")
    fleet_serve_integers(torch, routed, ints, dev, nnz_chunk, "fleet auto")
    st_b = routed.stats()
    got_b = read_launches()
    log(f"(b) auto: dispatches by strategy {seen_b}; launches {got_b}, "
        f"per-slot routed {slot_routed(st_b)}")
    if got_b != slot_routed(st_b) or min(got_b.values()) < 1:
        raise AssertionError(f"fleet auto launches {got_b} != per-slot "
                             f"routed {slot_routed(st_b)}")
    routed.close()
    reset_launches()
    # (c) zipf replication, (d) mutate() on a replicated graph
    zipf_stats, hot, x_hot = fleet_zipf(torch, dev, slots, nnz_chunk)
    zipf_stats.append(fleet_mutate(torch, slots, hot, x_hot, nnz_chunk))
    got_cd = read_launches()
    want_cd = {k: sum(slot_routed(s)[k] for s in zipf_stats)
               for k in got_cd}
    log(f"(c)-(d) launches {got_cd}, per-slot routed {want_cd}")
    if got_cd != want_cd:
        raise AssertionError(f"zipf/mutate launches {got_cd} != per-slot "
                             f"routed {want_cd}")
    paths = {k: got[k] + got_b[k] + got_cd[k] for k in got}
    # (e) hedging, (f) layer times: not on the counted path
    fleet_hedge(torch, dev, slots, small, nnz_chunk)
    single = GraphServeEngine(device=dev, backend="accel",
                              cache=fleet.cache)
    single.register_graph("Reddit", graphs["Reddit"])
    times = fleet_layer_times(torch, fleet, single, graphs["Reddit"])
    single.close()
    fleet.close()
    log(f"phase 15 (fleet) {time.perf_counter() - t_phase:.1f}s")
    return paths, times


MH_PROCESSES = 2           # phase 16: worker processes on the one card
MH_SLOTS = 2               # slots of the card in each worker
MH_F = {"Reddit": 256, "Arxiv": 256, "25m": 2048, "tiny": 2048}
MH_GLOBAL = "Reddit"       # the graph of the collective dispatch
MH_GLOBAL_REPS = 3         # serve_global calls (the first stages shares)
MH_MUTATE = "Arxiv"        # its integer copy takes one delta from rank 0
MH_SEEDS = 256             # straddling the store's partition boundary
MH_FANOUTS = [10, 10]
MH_REPS = 3                # timed requests per graph
MH_GATE_S = 300.0          # a phase gate waits this long for the peer
MH_GLOO_TIMEOUT_S = 120.0
MH_TIMEOUT_S = 540.0       # the whole two-process fleet


def launch_snapshot():
    """Every kernel's launches and launches by gather instance."""
    return {k: (fn.launches, dict(fn.launches_by_instance))
            for k, fn in kernel_counters().items()}


class LaunchLedger:
    """The launches of the multihost path: every launch since ``start``
    less those made inside ``aside()`` (reference answers and
    comparisons), which run only while no peer forwards to this rank."""

    def __init__(self):
        self.base = launch_snapshot()
        self.aside_by = {k: [0, {}] for k in self.base}

    def aside(self, fn):
        before = launch_snapshot()
        out = fn()
        after = launch_snapshot()
        for k, (n, inst) in after.items():
            self.aside_by[k][0] += n - before[k][0]
            for i, c in inst.items():
                self.aside_by[k][1][i] = (self.aside_by[k][1].get(i, 0) + c
                                          - before[k][1].get(i, 0))
        return out

    def path(self):
        now = launch_snapshot()
        out = {}
        for k, (n, inst) in now.items():
            out[k] = {"launches": n - self.base[k][0] - self.aside_by[k][0],
                      "by_instance": {
                          i: c - self.base[k][1].get(i, 0)
                          - self.aside_by[k][1].get(i, 0)
                          for i, c in inst.items()}}
        return out


def aggregate_oracle(torch, f, x, nnz_chunk, C):
    """A frontier's pure k-hop aggregate in fp64 (outermost block first),
    its magnitude, and the bound's depth: the largest summation k of each
    hop's rows, plus one per hop."""
    idx = torch.as_tensor(f.input_nodes, device=x.device)
    h = x[idx].double()
    m = h.abs()
    c = 0
    for k in range(f.num_hops - 1, -1, -1):
        blk = f.blocks[k].graph
        h = csr_oracle(torch, blk, h, nnz_chunk)
        m = csr_oracle(torch, blk, m, nnz_chunk, magnitude=True)
        c += int(summation_k(blk, C, False).max()) + 1
    return h, m, c


class PeerGates:
    """Named barriers between the two processes of a fleet over the peer
    data plane: ``signal(name)`` tells the peer this rank reached ``name``,
    ``wait(name)`` waits (MH_GATE_S at most) until the peer has."""

    def __init__(self, engine, tag, names):
        self.tag = tag
        self.events = {name: threading.Event() for name in names}
        for name, ev in self.events.items():
            engine.server.register(f"gate-{name}", lambda _p, ev=ev: ev.set())
        self.peer = None

    def connect(self, peer):
        """Bind the peer's client (once the fleet's channels are up)."""
        self.peer = peer

    def signal(self, name):
        self.peer.request(f"gate-{name}", None)

    def wait(self, name):
        if not self.events[name].wait(MH_GATE_S):
            raise AssertionError(f"{self.tag} peer never reached {name!r}")

    def gate(self, name):
        self.signal(name)
        self.wait(name)


def multihost_worker():
    """Phase 16, one worker process (started by ``phase_multihost`` through
    ``run_fleet``): a MultihostGraphEngine over this process's slots,
    driven with its peer as the module docstring's phase 16 says. Prints
    one JSON record as its last line."""
    import pickle
    import numpy as np
    import torch
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import (make_benchmark_graph,
                                         make_power_law_graph)
    from repro_torch.distributed.multihost import (FrontierExchange,
                                                   initialize_multihost)
    from repro_torch.distributed.shard_spmm import spmm_block_sharded
    from repro_torch.sampling import (GraphStore, PartitionedStoreClient,
                                      SamplingService, sample_frontier)
    from repro_torch.serve import (GraphRequest, GraphServeEngine,
                                   MultihostGraphEngine)
    t_start = time.perf_counter()
    ctx = initialize_multihost(timeout_s=MH_GLOO_TIMEOUT_S)
    rank, peer_rank = ctx.process_index, 1 - ctx.process_index
    dev = ctx.local_devices[0]
    card = dev.type == "cuda"
    if card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    tag = f"[rank {rank}]"
    rec = {"rank": rank, "card": card}

    # the graphs as phases 4-6 build them, and integer copies (values 1-2)
    t0 = time.perf_counter()
    graphs = {}
    for i, name in enumerate(GRAPHS):
        raw, _ = make_benchmark_graph(name, seed=i)
        graphs[name] = gcn_normalize(raw)
        if name == MH_GLOBAL:
            raw_global = raw
    for name, n, e in PRESET_GRAPHS:
        graphs[name] = gcn_normalize(make_power_law_graph(n, e, seed=0))
    ints = {f"{k}#int": integer_copy(g, 60 + i)
            for i, (k, g) in enumerate(graphs.items())}
    every = dict(graphs, **ints)
    rec["graphs_s"] = time.perf_counter() - t0

    engine = MultihostGraphEngine(context=ctx, backend="auto")
    gates = PeerGates(engine, tag, ("ready", "served", "timed-0", "timed-1",
                                    "global", "mutated", "store", "done"))
    t0 = time.perf_counter()
    owned = [name for name, g in every.items()
             if engine.register_graph(name, g) is not None]
    rec["owned"] = owned
    rec["register_s"] = time.perf_counter() - t0
    engine.connect_peers()
    peer = engine.peers[peer_rank]
    gates.connect(peer)

    # reference answers on one card, before any request is forwarded
    nnz_chunk = 1 << 17
    C = engine.config.deg_bound
    gen = torch.Generator(device=dev).manual_seed(70)
    feats = {}
    for name, g in every.items():
        F = MH_F[name.split("#")[0]]
        feats[name] = (int_features(torch, g.n_cols, F, gen, dev)
                       if name in ints else
                       torch.randn((g.n_cols, F), generator=gen, device=dev))
    ledger = LaunchLedger()
    single = GraphServeEngine(device=dev, backend="auto", cache=engine.cache,
                              max_graphs_per_batch=1)
    for name, g in every.items():
        single.register_graph(name, g)
    want = ledger.aside(lambda: {
        r.graph_id: r.out for r in single.serve(
            [GraphRequest(name, x) for name, x in feats.items()])})
    gates.gate("ready")

    # (5) both ranks serve every graph concurrently, each forwarding what
    # the other owns while it answers the other's forwards
    t0 = time.perf_counter()
    got = {r.graph_id: r.out for r in engine.serve(
        [GraphRequest(name, x) for name, x in feats.items()])}
    rec["serve_all_ms"] = (time.perf_counter() - t0) * 1e3
    errs = {}
    for name, y in got.items():
        g, x = every[name], feats[name]
        if name in ints:
            if not (torch.equal(y, want[name]) and torch.equal(
                    y.double(), csr_oracle(torch, g, x, nnz_chunk))):
                raise AssertionError(f"{tag} {name}: not exact")
            errs[name] = 0.0
        else:
            # a share of a block-sharded dispatch adds one partial per slot
            # and a K2 share its window partials: 4 more levels at most
            errs[name] = csr_check(torch, g, x, y, C, nnz_chunk,
                                   MH_SLOTS + 4)
            csr_check(torch, g, x, want[name], C, nnz_chunk, 4)
    rec["max_err"] = errs
    gates.gate("served")
    st = engine.stats()
    if st["fleet_forwarded"] < 1 or st["fleet_remote_served"] < 1:
        raise AssertionError(f"{tag} forwarded {st['fleet_forwarded']}, "
                             f"answered {st['fleet_remote_served']}")
    if st["fleet_host_failovers"] or min(st["fleet_dir_host_placements"]) < 1:
        raise AssertionError(f"{tag} failovers {st['fleet_host_failovers']}"
                             f", placements "
                             f"{st['fleet_dir_host_placements']}")

    # per graph: a local request where this rank owns the plan, a
    # forwarded one where the peer does; the ranks take turns, so a
    # forward never shares the card with the other rank's timing
    def timed(name):
        times = []
        for _ in range(MH_REPS):
            t = time.perf_counter()
            engine.serve_one(name, feats[name])
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[MH_REPS // 2]

    if rank == 1:
        gates.wait("timed-0")
    rec["request_ms"] = {name: timed(name) for name in every}
    gates.signal(f"timed-{rank}")
    if rank == 0:
        gates.wait("timed-1")
    rec["wire_bytes"] = {}
    for name in every:
        x_np = feats[name].cpu().numpy()
        ask = pickle.dumps(("serve", {"graph_id": name, "x": x_np}),
                           protocol=pickle.HIGHEST_PROTOCOL)
        out = np.zeros((every[name].n_rows, x_np.shape[1]), np.float32)
        answer = pickle.dumps(("ok", out), protocol=pickle.HIGHEST_PROTOCOL)
        rec["wire_bytes"][name] = len(ask) + len(answer) + 16

    # (7) the collective dispatch over the 4 global slots, K3 shares
    gates.gate("global")
    x_g = feats[MH_GLOBAL]
    x_gi = feats[f"{MH_GLOBAL}#int"]
    walls = []
    for _ in range(MH_GLOBAL_REPS):
        t = time.perf_counter()
        y_g = engine.serve_global(MH_GLOBAL, x_g)
        walls.append((time.perf_counter() - t) * 1e3)
    timing = dict(engine.last_global_timing)
    blocks = engine.stats()["fleet_block_counts"]
    fd = engine.last_fleet_decision
    y_gi = engine.serve_global(f"{MH_GLOBAL}#int", x_gi)
    st = engine.stats()
    if len(blocks) != len(ctx.global_devices) or \
            max(blocks) - min(blocks) > 1:
        raise AssertionError(f"{tag} global block counts {blocks}")
    g_err = csr_check(torch, graphs[MH_GLOBAL], x_g, y_g, C, nnz_chunk,
                      len(ctx.global_devices))
    plan_i = engine.plan_for(f"{MH_GLOBAL}#int")
    regime = fd.per_device.backend          # the engine's backend is auto
    one_process = ledger.aside(lambda: spmm_block_sharded(
        plan_i.slabs, x_gi, plan_i.n_rows,
        [dev] * len(ctx.global_devices), regime=regime)[0][plan_i.inv_perm])
    if not (torch.equal(y_gi, one_process) and torch.equal(
            y_gi.double(), csr_oracle(torch, ints[f"{MH_GLOBAL}#int"], x_gi,
                                      nnz_chunk))):
        raise AssertionError(f"{tag} global integer answer is not the "
                             f"one-process block sharding's")

    def single_ms():
        times = []
        for _ in range(MH_REPS):
            t = time.perf_counter()
            single.serve_one(MH_GLOBAL, x_g)
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[MH_REPS // 2]

    rec["global"] = {
        "strategy": fd.strategy, "regime": regime, "blocks": blocks,
        "max_err": g_err, "wall_ms": walls, "last": timing,
        "single_ms": ledger.aside(single_ms),
        "dispatches": st["fleet_global_dispatches"]}

    # (8) one delta from rank 0 on the integer Arxiv copy
    mut = f"{MH_MUTATE}#int"
    (delta,), (_, g_new) = chain_deltas(ints[mut], 80, True, n=1)
    if rank == 0:
        info = engine.mutate(mut, delta).result(timeout=MH_GATE_S)
        rec["mutate_info"] = {k: info[k] for k in ("version", "repaired",
                                                   "reason")}
    gates.gate("mutated")
    x_m = feats[mut]
    y_m = engine.serve_one(mut, x_m)
    if engine.graph_version(mut) != 1 or not torch.equal(
            y_m.double(), csr_oracle(torch, g_new, x_m, nnz_chunk)):
        raise AssertionError(f"{tag} {mut} after the delta: version "
                             f"{engine.graph_version(mut)} or not exact")
    st = engine.stats()
    rec["mutation"] = {"version": engine.graph_version(mut),
                       "plan_repairs": st["plan_repairs"],
                       "plan_rebuilds": st["plan_rebuilds"],
                       "broadcasts": st["fleet_mutation_broadcasts"],
                       "remote_mutations": st["fleet_remote_mutations"]}

    # (9) the Reddit store split in two, a 2-hop frontier through the
    # exchange, then served through a SamplingService on this engine
    t0 = time.perf_counter()
    full = GraphStore.build(raw_global, normalize=True)
    shards = full.partition(MH_PROCESSES)
    bounds = [s.node_range[0] for s in shards] + [full.n_nodes]
    FrontierExchange.serve(engine.server, shards[rank])
    rec["store_s"] = time.perf_counter() - t0
    gates.gate("store")
    exchange = FrontierExchange({peer_rank: peer})
    client = PartitionedStoreClient(shards[rank], bounds,
                                    exchange.remote_map(), rank)
    seeds = np.arange(bounds[1] - MH_SEEDS // 2, bounds[1] + MH_SEEDS // 2)
    t0 = time.perf_counter()
    fp = sample_frontier(client.sample_in_neighbors, seeds, MH_FANOUTS,
                         seed=7)
    sample_ms = (time.perf_counter() - t0) * 1e3
    fm = sample_frontier(full.sample_in_neighbors, seeds, MH_FANOUTS, seed=7)
    if fp.content_key() != fm.content_key() or exchange.failovers:
        raise AssertionError(f"{tag} exchanged frontier differs from the "
                             f"monolithic one (failovers "
                             f"{exchange.failovers})")
    svc = SamplingService(engine, client, MH_FANOUTS, sample_seed=7)
    x_s = torch.randn((full.n_nodes, MH_F[MH_GLOBAL]), generator=gen,
                      device=dev)
    y_s = svc.aggregate(seeds, x_s)
    want_s, mag_s, c_s = aggregate_oracle(torch, fp, x_s, nnz_chunk, C)
    rows = np.searchsorted(fp.layers[0], seeds)
    rows_t = torch.as_tensor(rows, device=dev)
    s_err = check_close("exchanged frontier", y_s, want_s[rows_t],
                        c_s * U * mag_s[rows_t])
    rec["frontier"] = {
        "layers": [len(layer) for layer in fp.layers],
        "remote_edges": int(client.remote_edges),
        "local_edges": int(client.local_edges),
        "requests": exchange.requests, "failovers": exchange.failovers,
        "sample_ms": sample_ms, "max_err": s_err}

    gates.gate("done")
    st = engine.stats()
    rec["stats"] = {k: st[k] for k in (
        "fleet_forwarded", "fleet_remote_served", "fleet_host_failovers",
        "fleet_host_forwarded", "fleet_dir_host_placements",
        "fleet_global_dispatches", "fleet_forward_busy_s",
        "requests_served", "batches_dispatched", "routed_resident",
        "routed_windowed", "routed_hbm")}
    rec["sched_invariant"] = (st["sched_completed"] + st["sched_failed"]
                              + st["sched_cancelled"]
                              == st["sched_submitted"])
    rec["launches"] = ledger.path()
    rec["slot_routed"] = slot_routed(st)
    rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if card else 0.0)
    rec["seconds"] = time.perf_counter() - t_start
    single.close()
    engine.close()
    import torch.distributed as dist
    dist.destroy_process_group()
    print(json.dumps(rec), flush=True)


def mh_worker_src(prelude="", entry="multihost_worker"):
    """The ``python -c`` body of a worker process: this script imported
    from its own directory, ``prelude`` run first, then ``entry()``."""
    return (f"import sys\nsys.path[:0] = [{SRC!r}, {ROOT!r}]\n{prelude}\n"
            f"import chip_smoke\nchip_smoke.{entry}()\n")


def phase_multihost(torch, card_line, device="cuda", prelude=""):
    """Phase 16, slice G: two worker processes of MH_SLOTS slots each on
    the one card (``run_fleet``), each a MultihostGraphEngine(backend=
    "auto"). Returns the K1/K2/K3 launches of the workers' paths."""
    from repro_torch.distributed.multihost import run_fleet
    t_phase = time.perf_counter()
    records = run_fleet(mh_worker_src(prelude), num_processes=MH_PROCESSES,
                        n_local_slots=MH_SLOTS, device=device,
                        timeout_s=MH_TIMEOUT_S, cwd=ROOT)
    recs = sorted(records, key=lambda r: r["rank"])
    owner = {name: r["rank"] for r in recs for name in r["owned"]}
    for r in recs:
        tag = f"rank {r['rank']}"
        st = r["stats"]
        log(f"{tag}: owns {r['owned']}; graphs built in "
            f"{r['graphs_s']:.1f}s, registered in {r['register_s']:.1f}s; "
            f"forwarded {st['fleet_forwarded']}, answered "
            f"{st['fleet_remote_served']} forwards, failovers "
            f"{st['fleet_host_failovers']}, placements per host "
            f"{st['fleet_dir_host_placements']}; all 8 graphs served "
            f"concurrently in {r['serve_all_ms']:.1f} ms, max err "
            + ", ".join(f"{k} {v:.2e}" for k, v in r["max_err"].items()))
        if (st["fleet_forwarded"] < 1 or st["fleet_remote_served"] < 1
                or st["fleet_host_failovers"] != 0
                or min(st["fleet_dir_host_placements"]) < 1
                or not r["sched_invariant"]):
            raise AssertionError(f"{tag}: {st}")
        for name, ms in r["request_ms"].items():
            how = "local" if owner[name] == r["rank"] else "forwarded"
            peer_ms = recs[owner[name]]["request_ms"][name]
            log(f"{tag} {name} F={MH_F[name.split('#')[0]]}: {how} request "
                f"{ms:.2f} ms (host clock, median of {MH_REPS})"
                + (f" against {peer_ms:.2f} ms local on rank {owner[name]}"
                   f"; {r['wire_bytes'][name]:,} bytes on the wire"
                   if how == "forwarded" else "") + f"; {card_line}")
        gl = r["global"]
        last = gl["last"]
        log(f"{tag} serve_global({MH_GLOBAL}) F={MH_F[MH_GLOBAL]}: "
            f"{gl['strategy']} over the 4 global slots, shares on "
            f"{gl['regime']}, live blocks {gl['blocks']}, max err "
            f"{gl['max_err']:.2e}; wall ms "
            f"{[round(w, 3) for w in gl['wall_ms']]}"
            f" (first stages the shares); last: shares "
            f"{last['shares_ms']:.3f} ms "
            f"({'CUDA events' if r['card'] else 'host clock'}), stage + "
            f"gloo gather "
            f"{last['gather_ms']:.3f} ms ({last['gather_bytes']:,} bytes "
            f"received), fold {last['fold_ms']:.3f} ms, wall "
            f"{last['wall_ms']:.3f}; single-card serve_one "
            f"{gl['single_ms']:.3f} ms; {card_line}")
        fr = r["frontier"]
        log(f"{tag} frontier of {MH_SEEDS} seeds across the boundary, "
            f"fanouts {MH_FANOUTS}: layers {fr['layers']}, "
            f"{fr['remote_edges']} edges sampled on the peer's shard in "
            f"{fr['requests']} requests, {fr['local_edges']} locally, "
            f"sampling {fr['sample_ms']:.1f} ms, failovers "
            f"{fr['failovers']}; identical to the monolithic store's; "
            f"aggregate max err {fr['max_err']:.2e}")
        log(f"{tag}: launches {r['launches']}, per-slot routed "
            f"{r['slot_routed']}; peak memory {r['peak_gib']:.2f} GiB; "
            f"{r['seconds']:.1f}s")
        path = {k: v["launches"] for k, v in r["launches"].items()}
        if path != r["slot_routed"]:
            raise AssertionError(f"{tag}: launches {path} != per-slot "
                                 f"routed {r['slot_routed']}")
    mut = [r["mutation"] for r in recs]
    log(f"mutation from rank 0 ({recs[0]['mutate_info']}): " + "; ".join(
        f"rank {r['rank']} {m}" for r, m in zip(recs, mut)))
    if ({m["version"] for m in mut} != {1}
            or sum(m["plan_repairs"] for m in mut) != 1
            or sum(m["plan_rebuilds"] for m in mut) != 0):
        raise AssertionError(f"mutation did not converge with one repair: "
                             f"{mut}")
    launches = {k: sum(r["launches"][k]["launches"] for r in recs)
                for k in ("K1", "K2", "K3")}
    if min(launches.values()) < 1:
        raise AssertionError(f"multihost launches {launches}")
    log(f"phase 16 (multihost, {MH_PROCESSES} processes x {MH_SLOTS} "
        f"slots) {time.perf_counter() - t_phase:.1f}s; launches {launches}")
    return launches


WITNESS_F = 256
WITNESS_THREADS = 4            # (a): submitter threads
WITNESS_REQUESTS = 32          # (a): requests per submitter
WITNESS_FEATURES = 2           # (a): feature matrices per graph
WITNESS_ZIPF_NODES = ZIPF_NODES[:3]
WITNESS_ZIPF_REQUESTS = 48
WITNESS_SEEDS = 64             # (c)
WITNESS_FANOUTS = [10, 10]
WITNESS_REPS = 5               # timed F=256 layers, with and without
WITNESS_TIMEOUT_S = 400.0      # the witnessed child; (d) has MH_TIMEOUT_S
# numpy binds threading.Lock when it is imported and takes its generators'
# locks in compiled code, which leaves no frame: imported after the patch,
# every generator a repro_torch function makes would be charged to it
WITNESS_PRELUDE = ("import numpy.random\n"
                   "from repro_torch.statics import witness\n"
                   "witness.install()\n")
# modules whose locks the witness must have wrapped (repro_torch.<name>)
WITNESS_CHILD_MODULES = (
    "core.plan_cache", "distributed.placement", "distributed.replication",
    "kernels.build", "kernels.spmm_accel", "sampling.service",
    "sampling.store", "serve.fleet", "serve.graph_engine", "serve.scheduler",
    "tuning.tuner")
WITNESS_WORKER_MODULES = (
    "core.plan_cache", "distributed.directory", "distributed.multihost",
    "distributed.placement", "kernels.build", "kernels.spmm_accel",
    "serve.fleet", "serve.graph_engine", "serve.scheduler")


def witness_graphs():
    """Phase 17's graphs: the Reddit and Arxiv analogues as phases 4-6
    build them (raw), and integer copies (values 1-2) of their normalized
    forms, keyed ``<name>#int``."""
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_benchmark_graph
    raws = {name: make_benchmark_graph(name, seed=i)[0]
            for i, name in enumerate(GRAPHS)}
    ints = {f"{name}#int": integer_copy(gcn_normalize(g), 60 + i)
            for i, (name, g) in enumerate(raws.items())}
    return raws, ints


def witness_layer_ms(torch, dev, ints, cache=None):
    """Median host ms of one served F=WITNESS_F layer of the integer
    Reddit copy through a fresh ``accel`` engine (``cache`` shared when
    given, so no plan is rebuilt), and that engine's dispatches."""
    from repro_torch.serve import GraphServeEngine
    name = f"{GRAPHS[0]}#int"
    g = ints[name]
    engine = GraphServeEngine(device=dev, backend="accel", cache=cache,
                              max_graphs_per_batch=1)
    engine.register_graph(name, g)
    gen = torch.Generator(device=dev).manual_seed(91)
    x = int_features(torch, g.n_cols, WITNESS_F, gen, dev)
    engine.serve_one(name, x)                       # builds or pins the plan
    ms = served_ms(torch, engine, name, x, reps=WITNESS_REPS)
    engine.close()
    return ms, engine.stats()["batches_dispatched"]


def witness_serve(torch, dev, ints, nnz_chunk):
    """Phase 17(a): an ``accel`` engine with a PlanTuner (every fourth
    dispatch of a graph is shadowed, one candidate) holds the integer
    Reddit and Arxiv copies; WITNESS_THREADS threads submit
    WITNESS_REQUESTS requests each at F=WITNESS_F while one ``mutate()`` on
    Arxiv is published mid-stream. Every answer equals the fp64 oracle of
    one published version, those after its publication the new one.
    Returns the engine (closed) and a record."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.plan_cache import PartitionConfig
    from repro_torch.serve import GraphServeEngine
    from repro_torch.tuning import PlanTuner, default_candidates
    tuner = PlanTuner(hot_rate=0.0, shadow_fraction=0.25,
                      candidates=default_candidates(PartitionConfig())[:1])
    engine = GraphServeEngine(device=dev, backend="accel", tuner=tuner)
    for name, g in ints.items():
        engine.register_graph(name, g)
    mut = f"{MUTATE_GRAPH}#int"
    (delta,), (_, g_new) = chain_deltas(ints[mut], 80, True, n=1)
    gen = torch.Generator(device=dev).manual_seed(90)
    feats = {name: [int_features(torch, g.n_cols, WITNESS_F, gen, dev)
                    for _ in range(WITNESS_FEATURES)]
             for name, g in ints.items()}
    want = {name: [csr_oracle(torch, ints[name], x, nnz_chunk) for x in xs]
            for name, xs in feats.items()}
    want_new = [csr_oracle(torch, g_new, x, nnz_chunk) for x in feats[mut]]
    names = list(ints)
    half, published = threading.Event(), threading.Event()

    def submitter(t):
        """Closed loop: each answer before the next request. Thread 0
        pauses half way until the mutation is published, so each version
        is read."""
        out = []
        for i in range(WITNESS_REQUESTS):
            if t == 0 and i == WITNESS_REQUESTS // 2:
                half.set()
                if not published.wait(600):
                    raise AssertionError("witness (a): no publication")
            name = names[(t + i) % len(names)]
            k = (i // len(names)) % WITNESS_FEATURES
            y = engine.submit(name, feats[name][k]).result(timeout=600)
            out.append((name, k, t == 0 and published.is_set(), y.double()))
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(WITNESS_THREADS) as pool:
        futs = [pool.submit(submitter, t) for t in range(WITNESS_THREADS)]
        if not half.wait(600):
            raise AssertionError("witness (a): submitters stalled")
        info = engine.mutate(mut, delta).result(timeout=600)
        published.set()
        got = [f.result(timeout=600) for f in futs]
    versions = [0, 0]
    for name, k, after, y in (item for items in got for item in items):
        if name == mut and torch.equal(y, want_new[k]):
            versions[1] += 1
        elif torch.equal(y, want[name][k]) and not (after and name == mut):
            versions[0] += name == mut
        else:
            raise AssertionError(f"witness (a) {name}: an answer equals "
                                 f"no published version's product, or an "
                                 f"old one after the publication")
    if min(versions) < 1:
        raise AssertionError(f"witness (a): reads of the old/new version "
                             f"{versions}")
    wall_ms = (time.perf_counter() - t0) * 1e3
    y = engine.serve_one(mut, feats[mut][0])
    if engine.graph_version(mut) != 1 or \
            not torch.equal(y.double(), want_new[0]):
        raise AssertionError("witness (a): the read after the mutation is "
                             "not the new version's product")
    engine.close()                  # waits for a shadow still in flight
    st = engine.stats()
    if st["shadow_dispatches"] < 1 or st["shadow_failures"]:
        raise AssertionError(f"witness (a): shadows {st['shadow_dispatches']}"
                             f", failures {st['shadow_failures']}")
    return engine, {
        "requests": WITNESS_THREADS * WITNESS_REQUESTS, "wall_ms": wall_ms,
        "mutated_reads": versions, "mutate": {
            k: info[k] for k in ("version", "repaired", "reason")},
        "dispatches": st["batches_dispatched"],
        "shadows": st["shadow_dispatches"],
        "promotions": st["tuned_promotions"]}


def witness_fleet(torch, dev, nnz_chunk):
    """Phase 17(b): a FleetGraphEngine (``accel``, replication on) over
    ``fleet_slots()`` serves the first WITNESS_ZIPF_NODES graphs of phase
    15's zipf mix twice (WITNESS_ZIPF_REQUESTS requests from 4 threads):
    every answer exact, at least one replica promoted."""
    from repro_torch.serve.fleet import FleetGraphEngine
    slots = ([torch.device("cpu")] * FLEET_SLOTS if dev.type == "cpu"
             else fleet_slots(torch))
    graphs, feats, schedule = zipf_mix(torch, dev, WITNESS_ZIPF_NODES,
                                       WITNESS_ZIPF_REQUESTS)
    e = FleetGraphEngine(devices=slots, **ZIPF_ENGINE, **ZIPF_REPLICATION)
    for k, g in graphs.items():
        e.register_graph(k, g)
    outs = zipf_pass(e, schedule, feats) + zipf_pass(e, schedule, feats)
    oracle = {k: csr_oracle(torch, g, feats[k], nnz_chunk)
              for k, g in graphs.items()}
    for gid, y in outs:
        if not torch.equal(y.double(), oracle[gid]):
            raise AssertionError(f"witness (b) {gid}: not exact")
    e.close()
    st = e.stats()
    if st["fleet_promotions"] < 1:
        raise AssertionError("witness (b): no replica promoted")
    return {"requests": len(outs), "slots": len(slots),
            "promotions": st["fleet_promotions"],
            "replica_copies": st["cache_replica_copies"],
            "slot_routed": slot_routed(st)}


def witness_sample(torch, dev, raw, engine, nnz_chunk):
    """Phase 17(c): one SamplingService batch of WITNESS_SEEDS seeds
    (fanouts WITNESS_FANOUTS) over a GraphStore of ``raw``, through
    ``engine``, within the first-order bound of its frontier's oracle."""
    import numpy as np
    from repro_torch.sampling import GraphStore, SamplingService
    store = GraphStore.build(raw, normalize=True)
    svc = SamplingService(engine, store, WITNESS_FANOUTS, sample_seed=7)
    seeds = np.sort(np.random.default_rng(5).choice(
        store.n_nodes, WITNESS_SEEDS, replace=False))
    gen = torch.Generator(device=dev).manual_seed(92)
    x = torch.randn((store.n_nodes, WITNESS_F), generator=gen, device=dev)
    y = svc.aggregate(seeds, x)
    f = svc.frontier_for(seeds)
    want, mag, c = aggregate_oracle(torch, f, x, nnz_chunk,
                                    engine.config.deg_bound)
    rows = torch.as_tensor(np.searchsorted(f.layers[0], seeds), device=dev)
    err = check_close("witness (c)", y, want[rows], c * U * mag[rows])
    return {"layers": [len(layer) for layer in f.layers], "max_err": err}


def witness_record(w, modules, tag):
    """The witness's summary, checked: no cycle, and at least one wrapped
    lock in each of ``modules``."""
    rec = w.summary()
    missing = [m for m in modules
               if rec["locks_by_module"].get(f"repro_torch.{m}", 0) < 1]
    if missing:
        raise AssertionError(f"{tag}: no lock witnessed in {missing}")
    w.assert_no_cycles()
    return rec


def witness_child():
    """Phase 17, the witnessed process: ``phase_witness`` starts it with
    the witness installed before any ``repro_torch`` import (the device in
    ``sys.argv[1]``). Runs (a), the witnessed twin of the parent's layer
    timing (on (a)'s plan cache), (c) and (b); prints one JSON record as
    its last line. Raises on a cycle or a missing module."""
    import torch
    from repro_torch.statics import witness
    w = witness.current()
    if w is None:
        raise AssertionError("witness child: the witness is not installed")
    t_start = time.perf_counter()
    dev = torch.device(sys.argv[1])
    nnz_chunk = 1 << 17
    raws, ints = witness_graphs()
    reset_launches()
    engine, rec_a = witness_serve(torch, dev, ints, nnz_chunk)
    layer_ms, timed = witness_layer_ms(torch, dev, ints, cache=engine.cache)
    from repro_torch.serve import GraphServeEngine
    sampler = GraphServeEngine(device=dev, backend="accel")
    rec_c = witness_sample(torch, dev, raws[MUTATE_GRAPH], sampler,
                           nnz_chunk)
    sampler.close()
    rec_b = witness_fleet(torch, dev, nnz_chunk)
    launches = read_launches()
    want_k1 = (rec_a["dispatches"] + 5 * rec_a["shadows"] + timed
               + sampler.stats()["batches_dispatched"]
               + rec_b["slot_routed"]["K1"])
    if launches != {"K1": want_k1, "K2": 0, "K3": 0}:
        raise AssertionError(f"witness child: launches {launches}, expected "
                             f"K1 {want_k1} (dispatches + 5 per shadow)")
    rec = {"serve": rec_a, "fleet": rec_b, "sample": rec_c,
           "layer_ms": layer_ms, "launches": launches,
           "seconds": time.perf_counter() - t_start,
           "witness": witness_record(w, WITNESS_CHILD_MODULES, "child")}
    print(json.dumps(rec), flush=True)


def witness_fleet_worker():
    """Phase 17(d), one of two ``run_fleet`` workers with the witness
    installed first: a MultihostGraphEngine (``accel``) holds an integer
    copy of the ``tiny`` preset graph (one owner); each rank reads it (the
    other forwards), rank 0 publishes one delta, each rank reads the new
    version. Every read exact. Prints one JSON record as its last line."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.distributed.multihost import initialize_multihost
    from repro_torch.serve import MultihostGraphEngine
    from repro_torch.statics import witness
    w = witness.current()
    if w is None:
        raise AssertionError("witness worker: the witness is not installed")
    t_start = time.perf_counter()
    ctx = initialize_multihost(timeout_s=MH_GLOO_TIMEOUT_S)
    rank = ctx.process_index
    dev = ctx.local_devices[0]
    tag = f"[witness rank {rank}]"
    reset_launches()
    name, n, e = PRESET_GRAPHS[-1]
    g = integer_copy(gcn_normalize(make_power_law_graph(n, e, seed=0)), 61)
    (delta,), (_, g_new) = chain_deltas(g, 81, True, n=1)
    engine = MultihostGraphEngine(context=ctx, backend="accel")
    gates = PeerGates(engine, tag, ("ready", "served", "mutated", "done"))
    owner = engine.register_graph(name, g) is not None
    engine.connect_peers()
    gates.connect(engine.peers[1 - rank])
    gen = torch.Generator(device=dev).manual_seed(93)
    x = int_features(torch, g.n_cols, WITNESS_F, gen, dev)
    nnz_chunk = 1 << 17
    gates.gate("ready")
    if not torch.equal(engine.serve_one(name, x).double(),
                       csr_oracle(torch, g, x, nnz_chunk)):
        raise AssertionError(f"{tag} {name}: not exact")
    gates.gate("served")
    if rank == 0:
        engine.mutate(name, delta).result(timeout=MH_GATE_S)
    gates.gate("mutated")
    y = engine.serve_one(name, x)
    if engine.graph_version(name) != 1 or not torch.equal(
            y.double(), csr_oracle(torch, g_new, x, nnz_chunk)):
        raise AssertionError(f"{tag} {name} after the delta: version "
                             f"{engine.graph_version(name)} or not exact")
    gates.gate("done")
    st = engine.stats()
    engine.close()
    dist.destroy_process_group()
    launches = read_launches()
    if launches != slot_routed(st):
        raise AssertionError(f"{tag} launches {launches} != per-slot routed "
                             f"{slot_routed(st)}")
    rec = {"rank": rank, "owner": owner, "launches": launches,
           "forwarded": st["fleet_forwarded"],
           "answered": st["fleet_remote_served"],
           "broadcasts": st["fleet_mutation_broadcasts"],
           "remote_mutations": st["fleet_remote_mutations"],
           "plan_repairs": st["plan_repairs"],
           "seconds": time.perf_counter() - t_start,
           "witness": witness_record(w, WITNESS_WORKER_MODULES, tag)}
    print(json.dumps(rec), flush=True)


def phase_witness(torch, card_line, device="cuda", prelude=""):
    """Phase 17: the port's lock-order witness on the served path. Times
    one F=WITNESS_F layer here (no witness), then runs ``witness_child``
    (a)-(c) in a fresh process and ``witness_fleet_worker`` in two
    ``run_fleet`` processes, each with the witness installed before any
    ``repro_torch`` import (``prelude`` runs after it). Every process must
    report no cycle. Returns the K1/K2/K3 launches made under the
    witness, and each process's record (``child``, ``workers``)."""
    from repro_torch.distributed.multihost import run_fleet
    t_phase = time.perf_counter()
    _, ints = witness_graphs()
    plain_ms, _ = witness_layer_ms(torch, torch.device(device), ints)
    del ints
    src = mh_worker_src(WITNESS_PRELUDE + prelude, entry="witness_child")
    proc = subprocess.run([sys.executable, "-c", src, device],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=WITNESS_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"witness child exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    workers = sorted(run_fleet(
        mh_worker_src(WITNESS_PRELUDE + prelude, entry="witness_fleet_worker"),
        num_processes=2, n_local_slots=1, device=device,
        timeout_s=MH_TIMEOUT_S, cwd=ROOT), key=lambda r: r["rank"])
    for who, rec in [("child", child)] + [(f"rank {r['rank']}", r)
                                          for r in workers]:
        wit = rec["witness"]
        if wit["cycles"]:
            raise AssertionError(f"witness {who}: cycles {wit['cycles']}")
        log(f"witness {who}: {wit['acquisitions']} acquisitions, "
            f"{wit['edges']} order edges, no cycle; instrumented locks per "
            f"module {wit['locks_by_module']}; launches {rec['launches']}; "
            f"{rec['seconds']:.1f}s")
    a, b, c = child["serve"], child["fleet"], child["sample"]
    log(f"witness (a): {a['requests']} requests from {WITNESS_THREADS} "
        f"threads in {a['wall_ms']:.1f} ms, {a['dispatches']} dispatches, "
        f"{a['shadows']} shadows, {a['promotions']} promotions; mutate "
        f"{a['mutate']} mid-stream, reads of the old/new version "
        f"{a['mutated_reads']}; all exact")
    log(f"witness (b): {b['requests']} zipf requests on {b['slots']} slots, "
        f"{b['promotions']} replica promotions, {b['replica_copies']} "
        f"replica copies, per-slot routed {b['slot_routed']}; all exact")
    log(f"witness (c): sampled batch layers {c['layers']}, max err "
        f"{c['max_err']:.2e}")
    if sum(r["forwarded"] for r in workers) < 1 or \
            sum(r["answered"] for r in workers) < 1 or \
            sum(r["plan_repairs"] for r in workers) != 1:
        raise AssertionError(f"witness (d): {workers}")
    log("witness (d): " + "; ".join(
        f"rank {r['rank']} owner {r['owner']}, forwarded {r['forwarded']}, "
        f"answered {r['answered']}, broadcasts {r['broadcasts']}, remote "
        f"mutations {r['remote_mutations']}" for r in workers))
    log(f"witness: one served F={WITNESS_F} layer of {GRAPHS[0]} (accel, "
        f"host clock, median of {WITNESS_REPS}): {child['layer_ms']:.3f} ms "
        f"witnessed, {plain_ms:.3f} ms unwitnessed; {card_line}")
    launches = {k: child["launches"][k] + sum(r["launches"][k]
                                              for r in workers)
                for k in ("K1", "K2", "K3")}
    if launches["K1"] < 1:
        raise AssertionError(f"witness launches {launches}")
    log(f"phase 17 (witness) {time.perf_counter() - t_phase:.1f}s; "
        f"launches {launches}")
    return launches, {"child": child, "workers": workers}


LM_ARCH = "phi3-mini-3.8b"   # examples/serve_lm.py's default arch, uncut
LM_BATCH = 4
LM_MAX_SEQ = 256
LM_MAX_NEW = 16               # examples/serve_lm.py's --max-new default
LM_PROMPT = 128               # (a)'s consistency prompt
LM_TIMED_BATCHES = (4, 32)    # (c)'s decode steps
LM_PREFILL_T = 512            # (c)'s prefill
# (c)'s engine load: (batch, requests) of LM_LOAD_PROMPT random tokens and
# LM_LOAD_NEW new tokens each, from as many closed-loop clients as slots
LM_LOAD = ((4, 64), (32, 256))
LM_LOAD_PROMPT = 128
LM_LOAD_NEW = 32
LM_BF16_LAYERS = 2            # (b): phi3's depth in the bf16 card-vs-CPU check
# (b): every other arch at full width, its depth cut to its smallest
# whole unit of layers
LM_CUTS = {
    "qwen1.5-32b": ({"n_layers": 2}, "2 of 64 layers"),
    "internlm2-20b": ({"n_layers": 2}, "2 of 48 layers"),
    "chameleon-34b": ({"n_layers": 2}, "2 of 48 layers"),
    "gemma2-27b": ({"n_layers": 2}, "one local/global pair of 23"),
    "deepseek-moe-16b": ({"n_layers": 2},
                         "the dense first layer + 1 of 27 MoE layers"),
    "dbrx-132b": ({"n_layers": 1}, "1 of 40 MoE layers"),
    "mamba2-780m": ({"n_layers": 2}, "2 of 48 layers"),
    "zamba2-7b": ({"n_layers": 7}, "one group (6 mamba layers + the "
                  "shared block) + 1 tail layer, of 81 mamba layers"),
    "hubert-xlarge": ({"n_layers": 2}, "2 of 48 layers, prefill only"),
}
# Bounds of phase 18, on the max over a result of |a - b| / max|b| (fp32)
# or of ||a - b|| / ||b|| over each logit vector (bf16):
# * fp32, one function computed twice (card against CPU, or prefill
#   against decode): the sums differ in order only. A dot product of
#   length K <= 36,864 (gemma-2's d_ff) carries ~sqrt(K) * 2**-24 ~ 1.1e-5
#   relative rounding; ~10 chained products per layer make ~1e-4; the
#   bound is 10x that.
# * bf16, phi3 at full depth, three paths (prefill, decode, forward): each
#   rounds the residual stream and every projection to bf16 (rms relative
#   error 2**-9 / sqrt(3) ~ 1.1e-3 per rounding) about 10 times per layer;
#   over 32 layers, sqrt(320) * 1.1e-3 ~ 0.02 relative on the logits where
#   two paths round differently, ~0.028 between two paths; the bound is
#   ~3.5x that. A wrong cache position, mask or rope angle decorrelates
#   the logits (~1.4).
LM_FP32_REL = 1e-3
LM_BF16_REL_RMS = 0.1
LM_RESET_TOL = 0.08           # tests/test_serve.py:73, phi3's slot reuse


def k_launches():
    """K1-K4's launch counters."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    return dict(read_launches(), K4=grouped_matmul.launches)


def rel_rms(torch, got, want):
    """max over the leading rows of ||got - want|| / ||want||, in fp64."""
    g, w = got.double().flatten(0, -2), want.double().flatten(0, -2)
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def rel_max(torch, got, want):
    g, w = got.double(), want.double()
    return float((g - w).abs().max() / w.abs().max())


def lm_paths(torch, lm, cfg, params, x, T, extra):
    """Logits of one model three ways: ``lm_forward`` over all T + extra
    positions, ``prefill_forward`` over T then ``extra`` decode steps. Each
    returned [B, extra + 1, V]: the positions T-1 .. T+extra-1."""
    with torch.inference_mode():
        full = lm.lm_forward(cfg, params, x)[:, T - 1:].float()
        lg, st = lm.prefill_forward(cfg, params, x[:, :T])
        st = lm.pad_prefill_caches(cfg, st, T + extra)
        dec = [lg.float()]
        for t in range(extra):
            lg, st = lm.decode_step(cfg, params, x[:, T + t:T + t + 1], st)
            dec.append(lg.float())
    return full, torch.stack(dec, 1)


def lm_serve_checks(torch, cfg, params, dev, card_line):
    """(a): the example's traffic through ServeEngine, then determinism."""
    from repro_torch.examples import serve_lm
    from repro_torch.serve import Request, ServeEngine
    engine = ServeEngine(cfg, params, batch=LM_BATCH, max_seq=LM_MAX_SEQ,
                         eos_id=-1, device=dev)
    try:
        out = serve_lm.drive(engine, LM_BATCH, LM_MAX_NEW)
        sync = [len(r.out) for r in out["sync"]]
        if sync != [LM_MAX_NEW - 2 * i for i in range(LM_BATCH - 1)]:
            raise AssertionError(f"generate() lengths {sync}")
        if [len(o) for o in out["async"]] != out["async_lengths"]:
            raise AssertionError("submit() answers of the wrong length")
        toks = [t for r in out["sync"] for t in r.out] + \
            [t for o in out["async"] for t in o]
        if not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError("a token outside the vocabulary")
        st = out["stats"]
        if st["slots_reused"] < 1:
            raise AssertionError(f"no slot reused: {st}")
        a = engine.generate([Request([5, 6, 7], 6)])[0].out
        b = engine.generate([Request([5, 6, 7], 6)])[0].out
        if a != b:
            raise AssertionError(f"the same prompt gave {a} then {b}")
    finally:
        engine.close()
    log(f"phase 18 (a) engine, the example's traffic (a smoke check, not a "
        f"load): {len(toks)} tokens, rounds {st['rounds']}, steps "
        f"{st['steps']}, slots_reused {st['slots_reused']}")
    return st


def lm_engine_load(torch, cfg, params, dev, card_line):
    """(c): ServeEngine under load. For each (batch, requests) of LM_LOAD,
    ``batch`` closed-loop clients (each submits its next request when its
    last is answered) send ``requests`` prompts of LM_LOAD_PROMPT random
    tokens for LM_LOAD_NEW new tokens each. Every answer must have its
    length and lie in the vocabulary, and no sequence may hit the cache."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serve import ServeEngine
    out = {}
    for batch, n_req in LM_LOAD:
        prompts = np.random.default_rng(8).integers(
            0, cfg.vocab, (n_req, LM_LOAD_PROMPT)).tolist()
        engine = ServeEngine(cfg, params, batch=batch, max_seq=LM_MAX_SEQ,
                             eos_id=-1, max_pending=n_req, device=dev)

        def client(c):
            return [engine.submit(prompts[i], LM_LOAD_NEW).result()
                    for i in range(c, n_req, batch)]

        try:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(batch) as pool:
                answers = [a for r in pool.map(client, range(batch))
                           for a in r]
            wall = time.perf_counter() - t0
            st = engine.stats()
        finally:
            engine.close()
        if len(answers) != n_req or any(
                len(a) != LM_LOAD_NEW for a in answers) or not all(
                0 <= t < cfg.vocab for a in answers for t in a):
            raise AssertionError(f"load B={batch}: malformed answers")
        if st["cache_exhausted"]:
            raise AssertionError(f"load B={batch}: {st['cache_exhausted']} "
                                 f"sequences hit the KV budget")
        rec = {"batch": batch, "requests": n_req, "wall_s": wall,
               "steps": st["steps"], "rounds": st["rounds"],
               "slots_reused": st["slots_reused"],
               "tokens": st["tokens_generated"],
               "tokens_per_s": st["tokens_per_s"],
               "all_tokens_per_s": (st["tokens_generated"]
                                    + st["prompt_tokens"])
               / st["total_round_s"],
               "step_ms": st["total_round_s"] / st["steps"] * 1e3,
               "slot_utilization": st["slot_utilization"],
               "p50_ms": st["sched_p50_latency_s"] * 1e3,
               "p99_ms": st["sched_p99_latency_s"] * 1e3}
        out[f"b{batch}"] = rec
        log(f"phase 18 (c) engine load B={batch}: {n_req} requests of "
            f"{LM_LOAD_PROMPT} prompt + {LM_LOAD_NEW} new tokens from "
            f"{batch} closed-loop clients, {wall:.1f}s: {rec['tokens']} "
            f"tokens generated, {rec['tokens_per_s']:.1f} tokens/s "
            f"generated ({rec['all_tokens_per_s']:.1f} with the prompt "
            f"tokens, which the engine feeds through the decode step), "
            f"slot_utilization {rec['slot_utilization']:.3f}, "
            f"{rec['steps']} steps in {rec['rounds']} rounds at "
            f"{rec['step_ms']:.3f} ms a step, slots_reused "
            f"{rec['slots_reused']}, latency p50 {rec['p50_ms']:.1f} ms, "
            f"p99 {rec['p99_ms']:.1f} ms (host clock, queue wait "
            f"included); {card_line}")
    return out


def lm_consistency(torch, lm, cfg, params, dev):
    """(a): the last-token logits of one 128-token prompt from prefill,
    from the prompt fed through decode_step, and from lm_forward."""
    import numpy as np
    T = LM_PROMPT
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, T)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        pre, _ = lm.prefill_forward(cfg, params, x)
        st = lm.init_decode_state(cfg, 1, T, device=dev)
        for t in range(T):
            dec, st = lm.decode_step(cfg, params, x[:, t:t + 1], st)
        full = lm.lm_forward(cfg, params, x)[:, -1]
    errs = {"prefill-decode": rel_rms(torch, pre, dec),
            "prefill-forward": rel_rms(torch, pre, full),
            "decode-forward": rel_rms(torch, dec, full)}
    if not all(e <= LM_BF16_REL_RMS for e in errs.values()):
        raise AssertionError(f"phi3 paths disagree: {errs}")
    if not bool(torch.isfinite(full).all()) or full.shape != (1, cfg.vocab):
        raise AssertionError("non-finite or misshapen logits")
    log(f"phase 18 (a) consistency, {T}-token prompt, bf16: relative rms "
        + ", ".join(f"{k} {v:.4f}" for k, v in errs.items())
        + f" (bound {LM_BF16_REL_RMS}); max |logit| "
        f"{float(full.abs().max()):.3f}")
    return errs


def lm_slot_reuse(torch, lm, cfg, params, dev):
    """(a): a recycled slot against a fresh state (tests/test_serve.py's
    case, at full width): atol = rtol = 0.08."""
    occupant, prompt = [5, 9, 2, 7], [3, 8, 6]

    def feed(st, toks):
        out = []
        with torch.inference_mode():
            for t in toks:
                lg, st = lm.decode_step(cfg, params, torch.tensor(
                    [[1], [t]], dtype=torch.int32, device=dev), st)
                out.append(lg[1].float())
        return out, st

    ref, _ = feed(lm.track_slot_starts(
        lm.init_decode_state(cfg, 2, 32, device=dev), 2), prompt)
    st = lm.track_slot_starts(lm.init_decode_state(cfg, 2, 32, device=dev),
                              2)
    _, st = feed(st, occupant)
    st = lm.reset_decode_slot(cfg, st, 1)
    got, _ = feed(st, prompt)
    worst = 0.0
    for r, g in zip(ref, got):
        excess = (g - r).abs() - LM_RESET_TOL * (1 + r.abs())
        worst = max(worst, float((g - r).abs().max()))
        if bool((excess > 0).any()):
            raise AssertionError(f"recycled slot off by {worst}")
    log(f"phase 18 (a) slot reuse vs a fresh state: max |diff| {worst:.4f} "
        f"(atol = rtol = {LM_RESET_TOL})")
    return worst


def lm_timing(torch, lm, cfg, params, dev, card_line, n_params):
    """(c): phi3's decode step at each of LM_TIMED_BATCHES and its prefill,
    by CUDA events, beside their bounds; one decode step's device time by
    torch.profiler."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.train.step import make_serve_step
    step = make_serve_step(cfg)
    embed = params["embed"].numel()
    kv_per_slot = 2 * cfg.n_layers * LM_MAX_SEQ * cfg.n_kv_heads \
        * cfg.d_head * 2
    times = {}
    for B in LM_TIMED_BATCHES:
        st = lm.init_decode_state(cfg, B, LM_MAX_SEQ, device=dev)
        st = st._replace(pos=LM_MAX_SEQ // 2)
        tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
        holder = {"st": st}

        def one():
            _, _, holder["st"] = step(params, holder["st"], tok)

        for _ in range(2):
            one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = cuda_ms(one, 10)
        wall = (time.perf_counter() - t0) * 1e3 / 10
        # bytes that must move: every weight but the embedding table's
        # unread rows, plus the whole static KV cache the step reads
        nbytes = (n_params - embed + B * cfg.d_model) * 2 + B * kv_per_slot
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        times[f"decode_b{B}"] = {"ms": ms, "wall_ms": wall,
                                 "bound_ms": bound, "bytes": nbytes}
        log(f"phase 18 (c) decode step B={B}, max_seq {LM_MAX_SEQ}: "
            f"{ms:.3f} ms (CUDA events over 10; host clock {wall:.3f} ms), "
            f"bound {bound:.3f} ms ({nbytes / 1e9:.3f} GB: weights "
            f"{(n_params - embed) * 2 / 1e9:.3f} + KV cache "
            f"{B * kv_per_slot / 1e9:.3f}, bytes), {bound / ms * 100:.1f}% "
            f"of it; {card_line}")
        if B == LM_TIMED_BATCHES[0]:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("decode_step"):
                    one()
                    torch.cuda.synchronize()
            # device events less the step's own range (its annotation)
            rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and e.key != "decode_step"]
            rows.sort(reverse=True)
            busy = sum(r[0] for r in rows)
            span = trace_span(prof, "decode_step")
            if busy <= 0 or span is None:
                log("phase 18 (c) profile: no device time recorded; "
                    "not measured")
            else:
                span_ms, busy_ms = span
                times["profile"] = {"busy_ms": busy, "span_ms": span_ms,
                                    "idle_share": 1 - busy_ms / span_ms,
                                    "kernels": sum(r[1] for r in rows)}
                log(f"phase 18 (c) profile of one decode step B={B}: "
                    f"device kernels {busy:.3f} ms in "
                    f"{times['profile']['kernels']} launches over the "
                    f"step's traced span of {span_ms:.3f} ms (kernels busy "
                    f"{busy_ms:.3f} ms of it): device idle "
                    f"{times['profile']['idle_share'] * 100:.1f}%")
                for ms_, count, key in rows[:8]:
                    log(f"phase 18 (c) profile:   {ms_:8.3f} ms "
                        f"{ms_ / busy * 100:5.1f}%  x{count:<4d} {key[:60]}")
                # the same device time by the op that launched it
                ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                              for e in prof.key_averages()
                              if e.device_type == DeviceType.CPU
                              and e.self_device_time_total > 0),
                             reverse=True)
                for ms_, count, key in ops[:8]:
                    log(f"phase 18 (c) profile by op: {ms_:8.3f} ms "
                        f"{ms_ / busy * 100:5.1f}%  x{count:<4d} {key[:40]}")
        del holder, st
    T = LM_PREFILL_T
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (1, T)).astype(np.int32)).to(dev)

    def prefill():
        with torch.inference_mode():
            lm.prefill_forward(cfg, params, x)

    prefill()
    torch.cuda.synchronize()
    ms = cuda_ms(prefill, 5)
    # operations: the layers' matmuls for T tokens, the head for the last
    # token only, and causal attention (QK^T and PV over T(T+1)/2 pairs);
    # bytes: every weight but the embedding's unread rows, read once
    layer_mm = sum(t.numel() for t in tree_leaves(params["layers"])
                   if t.dim() == 3)
    head = params["head"].numel() if "head" in params else embed
    attn = 4 * cfg.n_layers * cfg.n_heads * cfg.d_head * T * (T + 1) // 2
    flops = 2 * layer_mm * T + 2 * head + attn
    nbytes = (n_params - embed + T * cfg.d_model) * 2
    ops_ms = flops / BF16_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    times["prefill"] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                        "flops": flops, "bytes": nbytes}
    log(f"phase 18 (c) prefill B=1 T={T}: {ms:.3f} ms (CUDA events over 5), "
        f"bound {bound:.3f} ms ({by}: {flops / 1e12:.3f} TFLOP at the dense "
        f"bf16 rate = {ops_ms:.3f} ms, of which layer matmuls 2 x "
        f"{layer_mm} x {T}, the head 2 x {head} for the last token, "
        f"attention {attn / 1e9:.1f} GFLOP; {nbytes / 1e9:.3f} GB of "
        f"weights = {bytes_ms:.3f} ms), {bound / ms * 100:.1f}% of it; "
        f"{card_line}")
    return times


def tree_leaves(tree):
    """The tensors of a tree of dicts."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    return [tree]


def trace_span(prof, name):
    """(the traced span of the ``record_function`` ``name`` to its last
    kernel's end, the union of the device kernels' intervals in it), ms;
    None when the trace holds no device event. The range's own device
    annotation, also named ``name``, is not a kernel."""
    from torch.autograd import DeviceType
    events = prof.events()
    marks = [e for e in events if e.name == name
             and e.device_type == DeviceType.CPU]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA and e.name != name)
    if not marks or not kernels:
        return None
    t0 = marks[0].time_range.start
    t1 = max(marks[0].time_range.end, kernels[-1][1])
    busy, end = 0.0, t0
    for a, b in kernels:
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    return (t1 - t0) / 1e3, busy / 1e3


def tree_apply(fn, tree):
    """``fn`` on every tensor of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: tree_apply(fn, v) for k, v in tree.items()}
    return fn(tree)


def dropless(cfg):
    """``cfg`` with an expert capacity no routing can exceed (E / top_k)."""
    if cfg.family != "moe":
        return cfg
    return cfg.replace(moe_capacity_factor=max(
        cfg.moe_capacity_factor, cfg.n_experts / cfg.top_k))


def short_generate(cfg, params, dev):
    """Two requests through a 2-slot ServeEngine (bf16, on the card)."""
    from repro_torch.serve import Request, ServeEngine
    engine = ServeEngine(cfg, params, batch=2, max_seq=32, eos_id=-1,
                         device=dev)
    try:
        return [r.out for r in engine.generate(
            [Request([1, 7, 42], 4), Request([3, 11], 3)])]
    finally:
        engine.close()


def lm_cut_arch(torch, lm, arch, card_line, dev):
    """(b): one arch at full width and cut depth. bf16 weights from a CUDA
    generator; a short generate() in bf16; then an fp32 copy: prefill and
    4 decode steps against lm_forward on the card, and the same on the CPU
    from the same weights, each within LM_FP32_REL."""
    import numpy as np
    from repro_torch.configs import get_config
    cut, desc = LM_CUTS[arch]
    cfg = get_config(arch).replace(**cut)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_lm(cfg, gen, device=dev)
    n = lm.param_count(params)
    if n != lm.config_param_count(cfg):
        raise AssertionError(f"{arch}: {n} parameters drawn")
    B, T, extra = 2, 16, 4
    rng = np.random.default_rng(7)
    if cfg.frontend == "token":
        x = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T + extra))
                             .astype(np.int32))
    else:
        x = torch.from_numpy(rng.normal(size=(B, T, cfg.d_model))
                             .astype(np.float32))
    rec = {"params": n, "cut": desc}
    if cfg.family != "encoder":
        outs = short_generate(cfg, params, dev)
        if [len(o) for o in outs] != [4, 3] or not all(
                0 <= t < cfg.vocab for o in outs for t in o):
            raise AssertionError(f"{arch}: generate() gave {outs}")
    p32 = tree_apply(lambda t: t.float(), params)
    del params
    xd = x.to(dev)
    with torch.inference_mode():
        if cfg.family == "encoder":
            card = dec = lm.prefill_forward(cfg, p32, xd)[0]
            full = lm.lm_forward(cfg, p32, xd)
        else:
            full, card = lm_paths(torch, lm, cfg, p32, xd, T, extra)
            dec = card
            if dropless(cfg) is not cfg:
                # capacity drops depend on each call's tokens, so prefill
                # is held against decode with dropless expert capacity
                full, dec = lm_paths(torch, lm, dropless(cfg), p32, xd, T,
                                     extra)
    rec["prefill_vs_decode"] = rel_max(torch, dec, full)
    pcpu = tree_apply(lambda t: t.cpu(), p32)
    del p32
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with torch.inference_mode():
        if cfg.family == "encoder":
            cpu = lm.prefill_forward(cfg, pcpu, x)[0]
        else:
            _, cpu = lm_paths(torch, lm, cfg, pcpu, x, T, extra)
    rec["cpu_s"] = time.perf_counter() - t1
    del pcpu
    rec["card_vs_cpu"] = rel_max(torch, card.cpu(), cpu)
    if not (rec["prefill_vs_decode"] <= LM_FP32_REL
            and rec["card_vs_cpu"] <= LM_FP32_REL):
        raise AssertionError(f"{arch}: {rec}")
    rec["s"] = time.perf_counter() - t0
    what = ("frame logits" if cfg.family == "encoder"
            else f"prefill + {extra} decode steps")
    log(f"phase 18 (b) {arch} cut to {desc}: {n} params; {what} in fp32, "
        f"against lm_forward {rec['prefill_vs_decode']:.2e}"
        + (" (dropless)" if dropless(cfg) is not cfg else "")
        + f", card vs CPU "
        f"{rec['card_vs_cpu']:.2e} of max|logit| (bound {LM_FP32_REL}); "
        + ("" if cfg.family == "encoder" else "generate() ok in bf16; ")
        + f"{rec['s']:.1f}s ({rec['cpu_s']:.1f}s on the CPU); {card_line}")
    return rec


def lm_bf16_cpu(torch, lm, card_line, dev):
    """(b): phi3 at full width cut to LM_BF16_LAYERS layers, in bf16 as
    served: lm_forward, prefill and 4 decode steps on the card against the
    same functions on the CPU from the same weights, within the serving
    bound |card - cpu| <= LM_RESET_TOL * (1 + |cpu|)."""
    import numpy as np
    from repro_torch.configs import get_config
    full = get_config(LM_ARCH).n_layers
    cfg = get_config(LM_ARCH).replace(n_layers=LM_BF16_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_lm(cfg, gen, device=dev)
    B, T, extra = 2, 16, 4
    x = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (B, T + extra)).astype(np.int32))
    card = lm_paths(torch, lm, cfg, params, x.to(dev), T, extra)
    card = [c.cpu() for c in card]
    pcpu = tree_apply(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = lm_paths(torch, lm, cfg, pcpu, x, T, extra)
    cpu_s = time.perf_counter() - t0
    del pcpu
    rec = {"cpu_s": cpu_s}
    for what, g, w in zip(("forward", "prefill+decode"), card, cpu):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"phi3 bf16 {what}: non-finite logits")
        excess = (g - w).abs() - LM_RESET_TOL * (1 + w.abs())
        rec[what] = {"max_abs": float((g - w).abs().max()),
                     "rel_rms": rel_rms(torch, g, w),
                     "max_logit": float(w.abs().max())}
        if bool((excess > 0).any()):
            raise AssertionError(f"phi3 bf16 {what}, card vs CPU: {rec}")
    log(f"phase 18 (b) {LM_ARCH} cut to {LM_BF16_LAYERS} of {full} layers, bf16 "
        f"as served, card vs CPU: "
        + "; ".join(f"{k} max |diff| {v['max_abs']:.4f}, relative rms "
                    f"{v['rel_rms']:.4f} (max |logit| {v['max_logit']:.3f})"
                    for k, v in rec.items() if k != "cpu_s")
        + f" (bound atol = rtol = {LM_RESET_TOL}); {cpu_s:.1f}s on the CPU; "
        f"{card_line}")
    return rec


def phase_lm(torch, card_line, device="cuda"):
    """Phase 18: slice I's path (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    dev = torch.device(device)
    before = k_launches()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_lm(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n = lm.param_count(params)
    if n != lm.config_param_count(cfg):
        raise AssertionError(f"{LM_ARCH}: {n} parameters drawn, "
                             f"{lm.config_param_count(cfg)} counted")
    log(f"phase 18 (a) {LM_ARCH} at full width and depth ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}): {n} bf16 "
        f"parameters ({n * 2 / 1e9:.3f} GB) drawn on the card from seed 0 "
        f"in {time.perf_counter() - t0:.1f}s")
    rec = {"params": n}
    rec["engine"] = lm_serve_checks(torch, cfg, params, dev, card_line)
    rec["consistency"] = lm_consistency(torch, lm, cfg, params, dev)
    rec["slot_reuse"] = lm_slot_reuse(torch, lm, cfg, params, dev)
    rec["times"] = lm_timing(torch, lm, cfg, params, dev, card_line, n)
    rec["load"] = lm_engine_load(torch, cfg, params, dev, card_line)
    rec["peak_gib_phi3"] = torch.cuda.max_memory_allocated() / 2**30
    # phase 20 (b) resets the peak: after this phase's reading of it
    rec["dryrun"] = dryrun_decode_check(torch, lm, cfg, params, dev,
                                        card_line, rec["times"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["bf16_cpu"] = lm_bf16_cpu(torch, lm, card_line, dev)
    gc.collect()
    torch.cuda.empty_cache()
    rec["cut"] = {}
    for arch in LM_CUTS:
        rec["cut"][arch] = lm_cut_arch(torch, lm, arch, card_line, dev)
        gc.collect()
        torch.cuda.empty_cache()
    after = k_launches()
    if after != before:
        raise AssertionError(f"K1-K4 launched on the LM path: {before} -> "
                             f"{after}")
    rec["peak_gib"] = max(rec["peak_gib_phi3"],
                          torch.cuda.max_memory_allocated() / 2**30)
    rec["s"] = time.perf_counter() - t_phase
    log(f"phase 18 (d) K1-K4 launches unchanged over the phase ({after}): "
        f"none of them is on the LM path")
    log(f"phase 18 {rec['s']:.1f}s; peak device memory "
        f"{rec['peak_gib']:.2f} GiB ({rec['peak_gib_phi3']:.2f} with phi3 "
        f"served); {card_line}")
    return rec


# ------------------------------------------------------------ slice J
TRAIN_ARCH = LM_ARCH         # phi3-mini-3.8b, uncut
TRAIN_B, TRAIN_T = 4, 512    # (a)
TRAIN_STEPS = 6
TRAIN_TIMED = 2              # (a): steps 3-6 (0-based 2..5) are timed
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
TRAIN_CHUNK = 512            # loss, query and key chunks
TRAIN_LONG_T = 4096          # (b): train_4k's sequence length, at B=1
TRAIN_CUT_LAYERS = 2         # (c), (d): phi3 at full width, 2 layers
TRAIN_CPU_B, TRAIN_CPU_T = 2, 64   # (c)'s batch on the card and the CPU
TRAIN_MB_B, TRAIN_MB = 4, 2        # (d): B=4, microbatches of 2
TRAIN_ARCH_T = 512           # (e): B=1
TRAIN_RESTART = dict(steps=6, crash_at=3, batch=4, seq=32)   # (f)
ADAMW_BYTES = 28             # (a): bf16 grad and param, fp32 m, v, master:
                             # each read once and written once (grad: read)
# Bounds of phase 19:
# * (c) card against CPU, fp32, one step from the same weights and batch:
#   the CPU tests' bounds (tests/test_torch_train_step.py): loss and
#   grad_norm within 1e-5 relative; master within 1e-6 + 1e-5 |w| where
#   |g| >= 1e-3 max|g| of the leaf, and within 2.2 lr everywhere (a first
#   Adam step moves an entry by lr (+-1 + wd w): only the sign of g
#   matters, which two summation orders may flip where g is tiny).
# * (d) microbatches of 2 against the batch of 4, fp32: the losses within
#   1e-5 relative (a mean of two means of equal counts); each microbatch's
#   gradient is rounded to bf16 and the two are summed in bf16, so
#   elementwise |G_mb - G| <= (2u + u^2) (|g1| + |g2|) / 2 with u = 2**-8,
#   and the norms |‖G_mb‖ - ‖G‖| <= (2u + u^2) (‖g1‖ + ‖g2‖) / 2 (plus
#   1e-5 ‖G‖ for the fp32 sums' order), g1 and g2 each half's gradient
#   (their norms measured by a step on each half alone).
# * (f) a resumed run against an uninterrupted one on the card: the loss,
#   ce and grad_norm of steps 3-5 within 1e-3 relative, lr equal. Card runs
#   are not bit-reproducible (the embedding's backward adds rows with
#   atomics), and a last-bit gradient difference moves a bf16 param by an
#   ulp; on the CPU the same is bit for bit (tests/test_torch_loop.py).
TRAIN_MB_U = 2.0 ** -8
TRAIN_RESTART_REL = 1e-3


def leaf_digests(torch, tree, chunk=1 << 24):
    """One int64 per leaf: the wrapped sum of its 32-bit words. A leaf that
    did not change keeps its digest; a changed one could keep it only if
    its changes cancel exactly, and then the check below fails (it never
    passes a leaf that did not move)."""
    from repro_torch.optim.adamw import tree_leaves
    out = []
    for t in tree_leaves(tree):
        if t.dtype != torch.float32:
            raise TypeError(f"digest of {t.dtype}")
        words = t.reshape(-1).view(torch.int32)
        s = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, words.numel(), chunk):
            s += torch.sum(words[i:i + chunk], dtype=torch.int64)
        out.append(s)
    return torch.stack(out).tolist() if out else []


def masters_moved(torch, before, state):
    after = leaf_digests(torch, state.opt.master)
    return sum(a != b for a, b in zip(before, after)), len(after)


def train_batch_fn(torch, cfg, batch, seq, dev, seed=0):
    """(step) -> batch on ``dev``: ``token_batch_fn`` for a token frontend;
    bf16 frames and labels from a generator seeded by the step for a stub
    frontend (as ``repro_torch.launch.train`` draws them)."""
    from repro_torch.launch.train import _batch_fn
    from repro_torch.data.tokens import token_batch_fn
    if cfg.frontend == "token":
        bf_np = token_batch_fn(batch=batch, seq=seq, vocab=cfg.vocab,
                               seed=seed)
        return lambda s: {k: torch.from_numpy(v).to(dev)
                          for k, v in bf_np(s).items()}
    return _batch_fn(cfg, batch, seq, dev)


def train_flops(cfg, params, tokens, B, T):
    """Model FLOPs of one step: 6 x the matmul parameters (the layers'
    stacked weight matrices and the head) x tokens, plus causal attention
    (QK^T and PV over T(T+1)/2 pairs a sequence) x 3 (forward, backward);
    remat's second forward is not counted."""
    from repro_torch.optim.adamw import tree_leaves
    mm = sum(t.numel() for t in tree_leaves(params["layers"]) if t.dim() >= 3)
    mm += params["head"].numel() if "head" in params else \
        params["embed"].numel()
    attn = 4 * cfg.n_layers * cfg.n_heads * cfg.d_head * B * T * (T + 1) // 2
    return 6 * mm * tokens + 3 * attn, mm


def step_profile(torch, step, state, batch, params):
    """One train step under torch.profiler (shapes recorded): kernel
    launches, device time by op, the device-idle share over the step's own
    traced span, and the check that no stacked leaf's gradient came from a
    per-layer fill of the whole leaf (a zero/fill of a stacked leaf's
    shape, or a select_backward of one layer's slice of it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.optim.adamw import tree_leaves
    stacked = [t for t in tree_leaves(params["layers"]) if t.numel() >= 1 << 20]
    whole = {tuple(t.shape) for t in stacked}
    slices = {tuple(t.shape[1:]) for t in stacked}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function("train_step"):
            state, m = step(state, batch)
            torch.cuda.synchronize()
    events = prof.events()
    bad = [(e.name, e.input_shapes[0]) for e in events
           if e.device_type == DeviceType.CPU and e.input_shapes
           and ((e.name in ("aten::fill_", "aten::zero_")
                 and tuple(e.input_shapes[0]) in whole)
                or (e.name == "aten::select_backward"
                    and tuple(e.input_shapes[0]) in slices))]
    if bad:
        raise AssertionError(f"per-layer whole-leaf gradient fills: {bad[:4]}")
    stacks = sum(1 for e in events if e.device_type == DeviceType.CPU
                 and e.name == "aten::stack")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name != "train_step"]
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    # device time by the op that launched it; CUPTI's "Command Buffer Full"
    # marks the host waiting on a full launch queue, not an op
    ops = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0
                  and e.key != "Command Buffer Full"), reverse=True)
    full = [e for e in prof.key_averages() if e.key == "Command Buffer Full"]
    span = trace_span(prof, "train_step")
    out = {"launches": len(kernels), "stacks": stacks, "busy_ms": busy,
           "ops": [(k, ms_, n) for ms_, n, k in ops[:5]],
           "queue_full": full[0].count if full else 0}
    if span is not None and busy > 0:
        out["span_ms"], out["busy_in_span_ms"] = span
        out["idle_share"] = 1 - span[1] / span[0]
    return state, m, out


def lm_train_full(torch, lm, dev, card_line):
    """(a): phi3-mini-3.8b uncut, 6 steps through train_loop; timing,
    model-FLOPs share, adamw_update alone, peak memory, one profiled
    step. Returns (record, state, step) for (b)."""
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import adamw_update, tree_map
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    torch.cuda.synchronize()
    n = lm.param_count(state.params)
    if n != lm.config_param_count(cfg):
        raise AssertionError(f"{TRAIN_ARCH}: {n} parameters drawn")
    init_s = time.perf_counter() - t0
    state_gb = n * (2 + 12) / 1e9
    log(f"phase 19 (a) {TRAIN_ARCH} at full width and depth "
        f"({cfg.n_layers} layers): {n} parameters; train state (bf16 "
        f"params + fp32 m, v, master) {state_gb:.2f} GB on the card in "
        f"{init_s:.1f}s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           loss_chunk=TRAIN_CHUNK, q_chunk=TRAIN_CHUNK,
                           kv_chunk=TRAIN_CHUNK)
    bf = train_batch_fn(torch, cfg, TRAIN_B, TRAIN_T, dev)
    before = leaf_digests(torch, state.opt.master)
    marks, events, moved = [], [], []

    def timed(st, batch):
        marks.append(time.perf_counter())
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        st, m = step(st, batch)
        e1.record()
        events.append((e0, e1))
        if len(events) == 1:
            moved.append(masters_moved(torch, before, st))
        return st, m

    out = train_loop(state=state, train_step=timed, batch_fn=bf,
                     n_steps=TRAIN_STEPS, log_every=1,
                     log_fn=lambda s: log(f"phase 19 (a) {s}"))
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    state = out["state"]
    losses = [h["loss"] for h in out["history"]]
    if not all(math.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"phi3 losses {losses}")
    k, nl = moved[0]
    if k != nl:
        raise AssertionError(f"only {k}/{nl} master leaves moved at step 1")
    ms = sum(a.elapsed_time(b) for a, b in events[TRAIN_TIMED:]) \
        / (TRAIN_STEPS - TRAIN_TIMED)
    wall = (marks[-1] - marks[TRAIN_TIMED]) * 1e3 / (TRAIN_STEPS - TRAIN_TIMED)
    tokens = TRAIN_B * TRAIN_T
    flops, mm = train_flops(cfg, state.params, tokens, TRAIN_B, TRAIN_T)
    bound_ms = flops / BF16_FLOPS * 1e3
    rec = {"params": n, "losses": losses, "ms": ms, "wall_ms": wall,
           "tokens_per_s": tokens / (ms / 1e3), "flops": flops,
           "flops_bound_ms": bound_ms, "mfu": bound_ms / ms,
           "first_step_ms": events[0][0].elapsed_time(events[0][1])}
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 19 (a) losses {['%.4f' % x for x in losses]}; every one of "
        f"{nl} master leaves moved at step 1; peak device memory over the "
        f"steps {rec['peak_gib']:.2f} GiB "
        f"({rec['peak_gib'] * 2**30 / 1e9:.2f} GB; the state alone "
        f"{state_gb:.2f} GB, bf16 grads {n * 2 / 1e9:.2f} GB)")
    log(f"phase 19 (a) train step B={TRAIN_B} T={TRAIN_T}: {ms:.3f} ms "
        f"(CUDA events, steps 3-{TRAIN_STEPS}; host clock {wall:.3f} ms; "
        f"step 1 {rec['first_step_ms']:.3f} ms), {rec['tokens_per_s']:.1f} "
        f"tokens/s; model FLOPs {flops / 1e12:.2f} TFLOP (6 x {mm} matmul "
        f"parameters x {tokens} tokens + causal attention) = "
        f"{bound_ms:.3f} ms at the dense bf16 peak: {rec['mfu'] * 100:.1f}% "
        f"of it; {card_line}")
    # the optimizer alone, on constant bf16 gradients (the arithmetic does
    # not depend on the values)
    grads = tree_map(lambda p: torch.full_like(p, 1e-3), state.params)
    opt = {"st": state}

    def update():
        _, o, _ = adamw_update(grads, opt["st"].opt, opt["st"].params,
                               lr=TRAIN_LR)
        opt["st"] = opt["st"]._replace(opt=o)

    update()
    torch.cuda.synchronize()
    rec["adamw_ms"] = cuda_ms(update, 3)
    rec["adamw_bound_ms"] = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3
    state = opt["st"]
    del grads, opt
    log(f"phase 19 (a) adamw_update alone: {rec['adamw_ms']:.3f} ms (CUDA "
        f"events over 3), bytes bound {rec['adamw_bound_ms']:.3f} ms "
        f"({ADAMW_BYTES} B x {n} parameters = "
        f"{ADAMW_BYTES * n / 1e9:.1f} GB), "
        f"{rec['adamw_bound_ms'] / rec['adamw_ms'] * 100:.1f}% of it; "
        f"{card_line}")
    state, _, prof = step_profile(torch, step, state, bf(TRAIN_STEPS),
                                  state.params)
    rec["profile"] = prof
    rec["peak_all_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if "idle_share" not in prof:
        log("phase 19 (a) profile: no device time recorded; not measured")
    else:
        rec["idle_unprofiled"] = 1 - prof["busy_ms"] / ms
        log(f"phase 19 (a) profile of one step: {prof['launches']} kernel "
            f"launches, {prof['busy_ms']:.3f} ms of kernels; over the "
            f"step's traced span of {prof['span_ms']:.3f} ms (kernels busy "
            f"{prof['busy_in_span_ms']:.3f} ms of it) the device idles "
            f"{prof['idle_share'] * 100:.1f}% (the profiler's launch cost "
            f"stretches the host; the host waited on a full launch queue "
            f"{prof['queue_full']} times); against the unprofiled step's "
            f"{ms:.3f} ms by CUDA events the kernels leave "
            f"{rec['idle_unprofiled'] * 100:.1f}% idle; "
            f"{prof['stacks']} aten::stack (the stacked leaves' gradients), "
            f"no whole-leaf fill")
        for key, ms_, cnt in prof["ops"]:
            log(f"phase 19 (a) profile by op: {ms_:9.3f} ms "
                f"{ms_ / prof['busy_ms'] * 100:5.1f}%  x{cnt:<5d} {key[:40]}")
    return rec, state, step


def lm_train_long(torch, state_step, dev, card_line):
    """(b): one step at T=4096, B=1 (after a warm-up step)."""
    from repro_torch.configs import get_config
    state, step = state_step
    cfg = get_config(TRAIN_ARCH)
    bf = train_batch_fn(torch, cfg, 1, TRAIN_LONG_T, dev, seed=1)
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, bf(0))
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    state, m = step(state, bf(1))
    e1.record()
    torch.cuda.synchronize()
    loss = float(m["loss"])
    if not (math.isfinite(loss) and loss > 0):
        raise AssertionError(f"T={TRAIN_LONG_T} loss {loss}")
    rec = {"ms": e0.elapsed_time(e1), "loss": loss,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"phase 19 (b) one step at B=1, T={TRAIN_LONG_T}: {rec['ms']:.3f} ms "
        f"(CUDA events), loss {loss:.4f}, peak device memory "
        f"{rec['peak_gib']:.2f} GiB; {card_line}")
    return rec


def lm_grads(torch, lm, cfg, params, batch, chunk):
    """Each leaf's gradient of lm_loss (remat), in tree order."""
    from repro_torch.optim.adamw import tree_leaves, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    loss, _ = lm.lm_loss(cfg, live, batch["inputs"], batch["labels"],
                         loss_chunk=chunk, q_chunk=chunk, kv_chunk=chunk)
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def lm_train_cut(torch, lm, dev, card_line):
    """(c) and (d): phi3 at full width cut to 2 layers, fp32 copies of its
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import adamw_init, tree_leaves, tree_map
    from repro_torch.train.step import TrainState, make_train_step
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_CUT_LAYERS)
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    p32 = tree_map(lambda t: t.float(), params)
    del params
    n = lm.param_count(p32)
    kw = dict(peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP)
    # (c): one step on the card, one on the CPU, from the same weights
    T = TRAIN_CPU_T
    batch = train_batch_fn(torch, cfg, TRAIN_CPU_B, T, dev, seed=1)(0)
    g = [x.abs() for x in lm_grads(torch, lm, cfg, p32, batch, T)]
    step = make_train_step(cfg, loss_chunk=T, q_chunk=T, kv_chunk=T, **kw)
    pc = tree_map(torch.clone, p32)
    card, mc = step(TrainState(pc, adamw_init(pc)), batch)
    pcpu = tree_map(lambda t: t.cpu(), p32)
    t0 = time.perf_counter()
    cpu, mcpu = step(TrainState(pcpu, adamw_init(pcpu)),
                     {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    rec_c = {"params": n, "cpu_s": cpu_s}
    for key in ("loss", "grad_norm"):
        a, b = float(mc[key]), float(mcpu[key])
        rec_c[key] = abs(a - b) / abs(b)
        if rec_c[key] > 1e-5:
            raise AssertionError(f"(c) {key}: card {a}, CPU {b}")
    lr = float(mcpu["lr"])
    worst_sure = worst_all = 0.0
    for w, want, gl in zip(tree_leaves(card.opt.master),
                           tree_leaves(cpu.opt.master), g):
        d = (w.cpu() - want).abs()
        sure = (gl >= 1e-3 * gl.max()).cpu()
        worst_all = max(worst_all, float(d.max()) / (2.2 * lr))
        if bool(sure.any()):
            r = d[sure] / (1e-6 + 1e-5 * want.abs()[sure])
            worst_sure = max(worst_sure, float(r.max()))
    rec_c["master_all"], rec_c["master_sure"] = worst_all, worst_sure
    if worst_all > 1 or worst_sure > 1:
        raise AssertionError(f"(c) master outside its bound: {rec_c}")
    del card, cpu, pc, pcpu, g
    log(f"phase 19 (c) {TRAIN_ARCH} cut to {TRAIN_CUT_LAYERS} layers ({n} "
        f"parameters), fp32, TF32 off, one step B={TRAIN_CPU_B} T={T}, card "
        f"vs CPU: loss {rec_c['loss']:.2e}, grad_norm "
        f"{rec_c['grad_norm']:.2e} relative (bound 1e-5); master "
        f"{worst_sure:.3f} of 1e-6 + 1e-5|w| where |g| >= 1e-3 max|g|, "
        f"{worst_all:.3f} of 2.2 lr everywhere; the CPU step {cpu_s:.1f}s")
    # (d): microbatches of 2 against the batch of 4
    T = TRAIN_T
    batch = train_batch_fn(torch, cfg, TRAIN_MB_B, T, dev, seed=2)(0)
    half = TRAIN_MB_B // TRAIN_MB
    runs = {}
    for name, mb, sl in (("batch", None, slice(None)),
                         ("microbatch", TRAIN_MB, slice(None)),
                         ("g1", None, slice(0, half)),
                         ("g2", None, slice(half, None))):
        pc = tree_map(torch.clone, p32)
        st = make_train_step(cfg, microbatch=mb, loss_chunk=T, q_chunk=T,
                             kv_chunk=T, **kw)
        _, m = st(TrainState(pc, adamw_init(pc)),
                  {k: v[sl] for k, v in batch.items()})
        runs[name] = {k: float(v) for k, v in m.items()}
        del pc
    del p32
    G, Gm = runs["batch"]["grad_norm"], runs["microbatch"]["grad_norm"]
    u = TRAIN_MB_U
    bound = (2 * u + u * u) * (runs["g1"]["grad_norm"]
                               + runs["g2"]["grad_norm"]) / 2 + 1e-5 * G
    loss_rel = abs(runs["microbatch"]["loss"] - runs["batch"]["loss"]) \
        / abs(runs["batch"]["loss"])
    rec_d = {"loss_rel": loss_rel, "grad_norm_diff": abs(Gm - G),
             "grad_norm_bound": bound, "runs": runs}
    if loss_rel > 1e-5 or abs(Gm - G) > bound:
        raise AssertionError(f"(d) microbatching: {rec_d}")
    log(f"phase 19 (d) microbatch={TRAIN_MB} vs none at B={TRAIN_MB_B} "
        f"T={T}, fp32: loss {loss_rel:.2e} relative (bound 1e-5); grad_norm "
        f"{Gm:.6f} vs {G:.6f}, |diff| {abs(Gm - G):.3e} (bound {bound:.3e}: "
        f"bf16 sums of the halves' gradients, norms "
        f"{runs['g1']['grad_norm']:.4f} and {runs['g2']['grad_norm']:.4f})")
    return rec_c, rec_d


def lm_train_arch(torch, lm, arch, dev, card_line):
    """(e): one bf16 train step of ``arch`` at full width and LM_CUTS'
    depth, B=1, T=TRAIN_ARCH_T."""
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import init_train_state, make_train_step
    cut, desc = LM_CUTS[arch]
    desc = desc.replace(", prefill only", "")     # phase 18's serving note
    cfg = get_config(arch).replace(**cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    n = lm.param_count(state.params)
    p_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state.params))
    need = 2 * p_bytes + 12 * n          # params, grads, m, v, master
    T = TRAIN_ARCH_T
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           loss_chunk=T, q_chunk=T, kv_chunk=T)
    batch = train_batch_fn(torch, cfg, 1, T, dev, seed=3)(0)
    before = leaf_digests(torch, state.opt.master)
    try:
        state, m = step(state, batch)
        torch.cuda.synchronize()
    except torch.OutOfMemoryError as e:
        raise RuntimeError(
            f"{arch} cut to {desc}: {n} parameters, state + grads "
            f"{need / 1e9:.2f} GB, out of device memory after a peak of "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB") from e
    loss = float(m["loss"])
    k, nl = masters_moved(torch, before, state)
    if not (math.isfinite(loss) and loss > 0) or k != nl:
        raise AssertionError(f"{arch}: loss {loss}, {k}/{nl} master leaves "
                             f"moved")
    rec = {"params": n, "cut": desc, "loss": loss, "state_grads_gb": need / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "s": time.perf_counter() - t0}
    log(f"phase 19 (e) {arch} cut to {desc}: {n} parameters, one step B=1 "
        f"T={T}: loss {loss:.4f}, all {nl} master leaves moved; state + "
        f"grads {rec['state_grads_gb']:.2f} GB, peak {rec['peak_gb']:.2f} GB "
        f"({rec['s']:.1f}s); {card_line}")
    return rec


def lm_train_restart(torch, dev, card_line):
    """(f): train_loop on reduced phi3 with a CheckpointManager: crash at
    step 3, resume; the resumed history against an uninterrupted run."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = get_reduced(TRAIN_ARCH)
    r = TRAIN_RESTART
    step = make_train_step(cfg, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           loss_chunk=r["seq"], q_chunk=r["seq"],
                           kv_chunk=r["seq"])
    bf = train_batch_fn(torch, cfg, r["batch"], r["seq"], dev)

    def fresh():
        return init_train_state(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)

    def quiet(_):
        return None

    ref = train_loop(state=fresh(), train_step=step, batch_fn=bf,
                     n_steps=r["steps"], log_every=100, log_fn=quiet)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2)
        try:
            train_loop(state=fresh(), train_step=step, batch_fn=bf,
                       n_steps=r["steps"], ckpt=ck, ckpt_every=r["crash_at"],
                       crash_at=r["crash_at"], log_every=100, log_fn=quiet)
            raise AssertionError("crash_at did not raise")
        except RuntimeError as e:       # the simulated failure, nothing else
            if "simulated failure" not in str(e):
                raise
        if ck.latest_step() != r["crash_at"]:
            raise AssertionError(f"latest checkpoint {ck.latest_step()}")
        logs = []
        out = train_loop(state=fresh(), train_step=step, batch_fn=bf,
                         n_steps=r["steps"], ckpt=ck,
                         ckpt_every=r["crash_at"], log_every=100,
                         log_fn=logs.append)
    if f"[loop] resumed from checkpoint step {r['crash_at']}" not in logs:
        raise AssertionError(f"no resume: {logs}")
    want = ref["history"][r["crash_at"]:]
    got = out["history"]
    worst = 0.0
    for h, w in zip(got, want):
        if h["lr"] != w["lr"]:
            raise AssertionError(f"lr {h['lr']} vs {w['lr']}")
        for k in ("loss", "ce", "grad_norm"):
            worst = max(worst, abs(h[k] - w[k]) / abs(w[k]))
    if len(got) != len(want) or worst > TRAIN_RESTART_REL:
        raise AssertionError(f"resumed history off by {worst}: {got} vs "
                             f"{want}")
    rec = {"worst_rel": worst, "bit_equal": got == want,
           "losses": [h["loss"] for h in got]}
    log(f"phase 19 (f) {cfg.name} crash at step {r['crash_at']} and resume: "
        f"steps {r['crash_at']}-{r['steps'] - 1} within {worst:.2e} of the "
        f"uninterrupted run (bound {TRAIN_RESTART_REL}; bit-equal: "
        f"{rec['bit_equal']})")
    return rec


def phase_train_lm(torch, card_line, device="cuda"):
    """Phase 19: slice J's training path (see the module docstring)."""
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    dev = torch.device(device)
    before = k_launches()
    rec = {}
    rec["full"], state, step = lm_train_full(torch, lm, dev, card_line)
    rec["dryrun"] = dryrun_train_check(torch, state, dev, card_line,
                                       rec["full"]["ms"])
    rec["long"] = lm_train_long(torch, (state, step), dev, card_line)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    rec["card_vs_cpu"], rec["microbatch"] = lm_train_cut(torch, lm, dev,
                                                         card_line)
    gc.collect()
    torch.cuda.empty_cache()
    rec["archs"] = {}
    for arch in LM_CUTS:
        rec["archs"][arch] = lm_train_arch(torch, lm, arch, dev, card_line)
        gc.collect()
        torch.cuda.empty_cache()
    rec["restart"] = lm_train_restart(torch, dev, card_line)
    after = k_launches()
    if after != before:
        raise AssertionError(f"K1-K4 launched on the LM training path: "
                             f"{before} -> {after}")
    rec["launches"] = {k: after[k] - before[k] for k in after}
    # the sub-phases reset the peak: the phase's is the largest of theirs
    rec["peak_gib"] = max([rec["full"]["peak_all_gib"], rec["long"]["peak_gib"],
                           rec["dryrun"]["card_max_allocated"] / 2**30,
                           torch.cuda.max_memory_allocated() / 2**30]
                          + [r["peak_gb"] * 1e9 / 2**30
                             for r in rec["archs"].values()])
    rec["s"] = time.perf_counter() - t_phase
    log(f"phase 19 (g) K1-K4 launches unchanged over the phase ({after}): "
        f"none of them is on the LM training path")
    log(f"phase 19 {rec['s']:.1f}s; peak device memory "
        f"{rec['peak_gib']:.2f} GiB; {card_line}")
    return rec


# ------------------------------------------------------------ slice K
DRYRUN_PEAK_REL = 0.10       # (b): predicted peak against the card's
DRYRUN_CELLS = [("phi3-mini-3.8b", s) for s in
                ("train_4k", "prefill_32k", "decode_32k", "long_500k")] \
    + [("deepseek-moe-16b", "train_4k"), ("zamba2-7b", "decode_32k")]
DRYRUN_CLI = ["--arch", "phi3-mini-3.8b", "--shape", "decode_32k"]   # (c)
DRYRUN_OUT = os.path.join(ROOT, "chiprun_out", "dryrun_torch.json")


def card_step_peak(torch, base, counts):
    """The card's peak over a counted step in the tracker's terms: the
    allocator's peak less what the card held beside the step's arguments
    (``base`` is ``memory_allocated()`` just before the step)."""
    return torch.cuda.max_memory_allocated() - base + counts.argument_bytes


def dryrun_held(torch, label, cfg, shape, chunks, args, ms, card_line):
    """Phase 20 (b), one step: traced on ``meta``, then the same step on
    the card's ``args`` under the same counting mode; FLOPs and argument
    bytes equal, the peak within DRYRUN_PEAK_REL; the measured ``ms``
    beside the roofline's max(compute_s, memory_s)."""
    from repro_torch.analysis.counters import storage_bytes
    from repro_torch.analysis.roofline import hw_for
    from repro_torch.launch import dryrun as D
    pred, trace_s = D.trace_cell(cfg, shape, chunks=chunks)
    fn, _ = D.build_cell(cfg, shape, chunks=chunks)
    live = storage_bytes(args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card = D.run_counted(fn, args, shape.kind)
    torch.cuda.synchronize()
    peak = card_step_peak(torch, base, card)
    rl = D.cost_roofline(D.cost_vector(pred), hw=hw_for("cuda"))
    by = "operations" if rl.compute_s >= rl.memory_s else "bytes"
    bound_ms = max(rl.compute_s, rl.memory_s) * 1e3
    rec = {"label": label, "flops": pred.flops, "card_flops": card.flops,
           "argument_bytes": pred.argument_bytes, "live_bytes": live,
           "card_argument_bytes": card.argument_bytes,
           "peak": pred.peak_live_bytes, "card_peak": peak,
           "card_max_allocated": peak + base - card.argument_bytes,
           "bytes": pred.bytes, "card_bytes": card.bytes,
           "trace_s": trace_s, "card_counted_s": card.seconds,
           "ms": ms, "bound_ms": bound_ms, "bound_by": by,
           "share": bound_ms / ms}
    log(f"phase 20 (b) {label}: FLOPs {pred.flops} predicted on meta "
        f"(trace {trace_s:.1f}s), {card.flops} counted on the card; "
        f"argument bytes {pred.argument_bytes} predicted, {live} live on "
        f"the card ({card.argument_bytes} counted there); peak "
        f"{pred.peak_live_bytes} B ({pred.peak_live_bytes / 2**30:.3f} GiB) "
        f"predicted, {peak} B on the card (max_memory_allocated "
        f"{rec['card_max_allocated']} B less {base - card.argument_bytes} "
        f"B held beside the arguments; the tracker counted "
        f"{card.peak_live_bytes} B there), "
        f"{(pred.peak_live_bytes / peak - 1) * 100:+.4f}%; "
        f"eager bytes {pred.bytes:.4e} predicted, {card.bytes:.4e} on the "
        f"card; {card_line}")
    log(f"phase 20 (b) {label}: {ms:.3f} ms (CUDA events) against "
        f"max(compute {rl.compute_s * 1e3:.3f}, memory "
        f"{rl.memory_s * 1e3:.3f}) = {bound_ms:.3f} ms ({by}; the eager "
        f"program's op-by-op bytes): {rec['share'] * 100:.1f}% of the "
        f"roofline; {card_line}")
    if card.flops != pred.flops:
        raise AssertionError(f"{label}: FLOPs {card.flops} on the card, "
                             f"{pred.flops} predicted")
    if not pred.argument_bytes == card.argument_bytes == live:
        raise AssertionError(f"{label}: argument bytes {pred.argument_bytes}"
                             f" predicted, {card.argument_bytes} counted, "
                             f"{live} live")
    if abs(pred.peak_live_bytes - peak) > DRYRUN_PEAK_REL * peak:
        raise AssertionError(f"{label}: peak {pred.peak_live_bytes} "
                             f"predicted, {peak} on the card")
    return rec


def dryrun_decode_check(torch, lm, cfg, params, dev, card_line, times):
    """Phase 20 (b) on phase 18's decode steps, at phase 18's weights."""
    from repro_torch.configs.base import ShapeConfig
    out = []
    for B in LM_TIMED_BATCHES:
        st = lm.init_decode_state(cfg, B, LM_MAX_SEQ, device=dev)
        st = st._replace(pos=LM_MAX_SEQ // 2)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        shape = ShapeConfig(f"decode_b{B}", "decode", LM_MAX_SEQ, B)
        out.append(dryrun_held(torch, f"{LM_ARCH} decode step B={B} "
                               f"max_seq {LM_MAX_SEQ}", cfg, shape, None,
                               (params, st, tok),
                               times[f"decode_b{B}"]["ms"], card_line))
        del st, tok
    return out


def dryrun_train_check(torch, state, dev, card_line, ms):
    """Phase 20 (b) on phase 19's train step, on its state."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config(TRAIN_ARCH)
    # each input its own [B, T] tensor, as the specs have it (on the CPU the
    # token batch is two views of one [B, T + 1] array; the card's copies)
    batch = {k: v.contiguous() for k, v in train_batch_fn(
        torch, cfg, TRAIN_B, TRAIN_T, dev)(TRAIN_STEPS).items()}
    chunks = {"q_chunk": TRAIN_CHUNK, "kv_chunk": TRAIN_CHUNK,
              "loss_chunk": TRAIN_CHUNK}
    shape = ShapeConfig("train_b4", "train", TRAIN_T, TRAIN_B)
    return dryrun_held(torch, f"{TRAIN_ARCH} train step B={TRAIN_B} "
                       f"T={TRAIN_T}", cfg, shape, chunks, (state, batch),
                       ms, card_line)


def phase_dryrun(torch, card_line, held):
    """Phase 20: slice K's dry run (see the module docstring); ``held`` are
    (b)'s records from phases 18 and 19."""
    from repro_torch.analysis.roofline import hw_for, model_flops_estimate
    from repro_torch.configs import SHAPES_BY_NAME, get_config, shape_skips
    from repro_torch.launch import dryrun as D
    t_phase = time.perf_counter()
    hw = hw_for("cuda")
    log(f"phase 20 (a) roofline against {hw['name']}: data-sheet peaks "
        f"{hw['peak_flops'] / 1e12:.1f} TFLOP/s bf16, "
        f"{hw['hbm_bw'] / 1e12:.2f} TB/s, NVLink {hw['link_bw'] / 1e9:.0f} "
        f"GB/s each way, at 700 W; measured card {card_line}")
    rec = {"cells": {}, "held": held}
    for arch, name in DRYRUN_CELLS:
        cfg, shape = get_config(arch), SHAPES_BY_NAME[name]
        skip = shape_skips(cfg, shape)
        if skip:
            rec["cells"][f"{arch}:{name}"] = {"skipped": skip}
            log(f"phase 20 (a) {arch} x {name}: skipped ({skip})")
            continue
        t0 = time.perf_counter()
        cost = D.probe_roofline(cfg, shape)
        tokens = shape.global_batch * (shape.seq_len if shape.kind in
                                       ("train", "prefill") else 1)
        mf = model_flops_estimate(D.active_param_count(cfg), tokens,
                                  "train" if shape.kind == "train"
                                  else "infer")
        rl = D.cost_roofline(cost, model_flops=mf, hw=hw)
        rec["cells"][f"{arch}:{name}"] = {**rl.to_row(),
                                          "s": time.perf_counter() - t0}
        if not (rl.flops > 0 and rl.bytes_hbm > 0 and rl.collective_s == 0
                and 0 < rl.useful_ratio <= 1):
            raise AssertionError(f"{arch} x {name}: {rl}")
        log(f"phase 20 (a) {arch} x {name} (whole depth, probe chunks, "
            f"meta; {rec['cells'][f'{arch}:{name}']['s']:.1f}s): "
            f"{rl.flops:.4e} FLOP, {rl.bytes_hbm:.4e} B; compute "
            f"{rl.compute_s * 1e3:.3f} ms, memory {rl.memory_s * 1e3:.3f} "
            f"ms, collective {rl.collective_s * 1e3:.3f} ms -> "
            f"{rl.bottleneck}-bound; useful_ratio {rl.useful_ratio:.3f}; "
            f"{card_line}")
    out = DRYRUN_OUT
    if os.path.exists(out):
        os.remove(out)
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *DRYRUN_CLI, "--out", out],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"dryrun CLI exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    with open(out) as f:
        [cli] = json.load(f)
    want = {"arch", "shape", "kind", "h100", "pod16x16", "multipod2x16x16",
            "roofline"}
    if not want <= set(cli) or cli["roofline"]["hw"] != hw["name"] or \
            set(cli["h100"]["rolled_cost"]) != {"flops", "bytes", "coll"}:
        raise AssertionError(f"dryrun CLI record {sorted(cli)}")
    rec["cli"] = {"s": time.perf_counter() - t0, "record": cli}
    log(f"phase 20 (c) python -m repro_torch.launch.dryrun "
        f"{' '.join(DRYRUN_CLI)}: exit 0 in {rec['cli']['s']:.1f}s; h100 row args "
        f"{cli['h100']['argument_bytes_per_dev'] / 1e9:.3f} GB, temp "
        f"{cli['h100']['temp_bytes_per_dev'] / 1e9:.3f} GB, pod16x16 args "
        f"{cli['pod16x16']['argument_bytes_per_dev'] / 1e9:.3f} GB a "
        f"device; roofline {cli['roofline']['bottleneck']}-bound on "
        f"{cli['roofline']['hw']}")
    for h in held:
        log(f"phase 20 (b) held: {h['label']}: FLOPs equal ({h['flops']}), "
            f"argument bytes equal ({h['argument_bytes']}), peak "
            f"{(h['peak'] / h['card_peak'] - 1) * 100:+.2f}% of the card's, "
            f"{h['ms']:.3f} ms against a {h['bound_ms']:.3f} ms "
            f"{h['bound_by']} bound ({h['share'] * 100:.1f}%)")
    rec["s"] = time.perf_counter() - t_phase
    log(f"phase 20 {rec['s']:.1f}s; {card_line}")
    return rec


# ------------------------------------------------------------ slice L
SHARD_ARCH = LM_ARCH            # phi3-mini-3.8b
SHARD_LAYERS = 4                # (a): full width, depth cut (phase 19 runs 32)
SHARD_B, SHARD_T = 4, 512       # (a): the train step's batch
SHARD_STEPS = 3                 # (a): train steps
SHARD_PROMPT = 128              # (a): prefill length, then greedy decode
SHARD_DECODE = 4                # (a): decode steps
SHARD_REL = 1e-5                # (a), N > 1 cards: fp32, as the CPU tests
SHARD_CELLS = ("train_4k", "decode_32k")   # (b): rank 0 of pod16x16
SHARD_PEAK_REL = 0.01           # (b): measured peak against the dry run's
# (b): the card's children run the allocator as the dry run predicts it:
# every block split to its request rounded up to 512 bytes
SHARD_ALLOC_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
SHARD_TIMED = 1                 # (b): timed steps after the counted one
SHARD_TIMEOUT_S = 900.0


def _shard_child(entry, args, out, env_extra=None, kwargs=None):
    """A ``python -c`` child running ``chip_smoke.<entry>(*args,
    **kwargs)``, its JSON result written to ``out``."""
    src = (f"import sys\nsys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
           f"import chip_smoke\nchip_smoke.{entry}(*{args!r}, "
           f"out={out!r}, **{kwargs or {}!r})\n")
    env = dict(os.environ, PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-c", src], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _shard_wait(procs, t0, what):
    """Waits for ``procs`` (the phase's limit from ``t0``); raises with the
    tail of each failed child's errors, after killing the rest."""
    errs = []
    for i, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=max(
                1.0, SHARD_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what} {i}: no result in "
                                 f"{SHARD_TIMEOUT_S:.0f}s")
        for line in so.splitlines():
            log(f"  [{what} {i}] {line}")
        if p.returncode:
            errs.append(f"{what} {i} exit {p.returncode}: {se[-3000:]}")
    if errs:
        raise AssertionError("\n".join(errs))


def _whole_leaves(torch, tree, names):
    """The named leaves of a parameter tree, whole, as fp32 CPU tensors."""
    from repro_torch.train.step import whole
    out = {}
    for name in names:
        t = tree
        for k in name.split("."):
            t = t[k]
        out[name] = whole(t).detach().float().cpu()
    return out


SHARD_SAMPLE = ("embed", "head", "final_norm.w", "layers.attn.wq",
                "layers.attn.wo", "layers.mlp.wg", "layers.mlp.wo",
                "layers.ln2.w")


class _HostEvent:
    """``torch.cuda.Event``'s timing on the host clock (a CPU rehearsal)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _events(torch, dev):
    if dev.type == "cuda":
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
    return _HostEvent(), _HostEvent()


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def shard_real_worker(rank, world, init, out, device="cuda",
                      microbatch=None):
    """Phase 21 (a), one rank: the partitioned program over every visible
    card (nccl, ``make_host_mesh()``) against the one-card program in the
    same process, from the same seed (``device="cpu"``: gloo, a CPU
    rehearsal); phase 22 (a) with ``microbatch``."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.counters import count_call
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_device_mesh, make_host_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.sharding import distribute, param_specs
    from repro_torch.train.step import (TrainState, make_serve_step,
                                        make_train_step, whole)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device(device, rank) if cuda else torch.device(device)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        cfg = get_config(SHARD_ARCH).replace(n_layers=SHARD_LAYERS)
        sizes = make_host_mesh(device=device)
        mesh = make_device_mesh(sizes, device=device)
        fp32 = world > 1

        def params_from_seed():
            p = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
            return tree_map(lambda t: t.float(), p) if fp32 else p

        bf = train_batch_fn(torch, cfg, SHARD_B, SHARD_T, dev)
        kw = dict(peak_lr=3e-4, warmup=2, loss_chunk=512, q_chunk=512,
                  kv_chunk=512)
        res = {"rank": rank, "world": world, "mesh": sizes,
               "layers": SHARD_LAYERS, "fp32": fp32,
               "microbatch": microbatch}
        runs = {}
        for name in ("partitioned", "one card"):
            p = params_from_seed()
            if name == "partitioned":
                p = distribute(p, param_specs(p, mesh), mesh)
            state = TrainState(p, adamw_init(p))
            step = make_train_step(cfg, microbatch=microbatch, **kw)
            losses, ms, counts = [], [], None
            _sync(torch, dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            for i in range(SHARD_STEPS):
                batch = bf(i)
                a, b = _events(torch, dev)
                a.record()
                if i == SHARD_STEPS - 1:   # both counted: the same kernels
                    (state, m), counts = count_call(step, state, batch)
                else:
                    state, m = step(state, batch)
                b.record()
                _sync(torch, dev)
                ms.append(a.elapsed_time(b))
                losses.append((float(m["loss"]), float(m["grad_norm"])))
            leaves = _whole_leaves(torch, state.params, SHARD_SAMPLE)
            prompt = bf(99)["inputs"][:, :SHARD_PROMPT].contiguous()
            with torch.inference_mode():
                lg, st = lm.prefill_forward(cfg, state.params, prompt)
                lg = whole(lg)
                st = lm.pad_prefill_caches(cfg, st, SHARD_PROMPT
                                           + SHARD_DECODE)
                tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
                toks, logits = [tok], [lg.float().cpu()]
                serve = make_serve_step(cfg)
                for _ in range(SHARD_DECODE):
                    tok, lg, st = serve(state.params, st, tok)
                    toks.append(tok)
                    logits.append(lg.float().cpu())
            runs[name] = {"losses": losses, "ms": ms, "leaves": leaves,
                          "tokens": torch.cat(toks, 1).cpu(),
                          "logits": logits,
                          "peak": (torch.cuda.max_memory_allocated()
                                   if cuda else 0),
                          "counts": counts}
            del state, p, st
            if cuda:
                torch.cuda.empty_cache()
        a, b = runs["partitioned"], runs["one card"]
        if fp32:
            def err(x, y):
                return float((x - y).abs().max() / max(float(y.abs().max()),
                                                       1e-30))
        else:
            def err(x, y):
                return 0.0 if torch.equal(x, y) else float(
                    (x - y).abs().max())
        res["loss_err"] = max(abs(x[0] - y[0]) / abs(y[0])
                              for x, y in zip(a["losses"], b["losses"]))
        res["loss_equal"] = a["losses"] == b["losses"]
        res["leaf_err"] = {k: err(a["leaves"][k], b["leaves"][k])
                           for k in SHARD_SAMPLE}
        res["logit_err"] = max(err(x, y) for x, y in zip(a["logits"],
                                                          b["logits"]))
        res["tokens_equal"] = bool(torch.equal(a["tokens"], b["tokens"]))
        res["losses"] = a["losses"]
        res["ms"] = {k: v["ms"] for k, v in runs.items()}
        res["peak_gib"] = {k: v["peak"] / 2**30 for k, v in runs.items()}
        c = a["counts"]
        res["coll_bytes"] = c.coll_bytes
        res["coll_n"] = {}
        for kind, *_ in c.collectives:
            res["coll_n"][kind] = res["coll_n"].get(kind, 0) + 1
        res["flops"] = {k: v["counts"].flops for k, v in runs.items()}
        res["k_launches"] = k_launches()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def shard_cfg(layers=None):
    """``SHARD_ARCH`` at full width, its depth cut to ``layers``."""
    from repro_torch.configs import get_config
    cfg = get_config(SHARD_ARCH)
    return cfg if layers is None else cfg.replace(n_layers=layers)


def shard_meta_worker(cell, out, chunks=None, layers=None):
    """Phase 21 (b), the prediction: rank 0's share of ``cell`` on
    pod16x16, traced on meta under a fake group (the dry run's row);
    phase 22 (b) with ``chunks``' microbatch and ``layers``."""
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    cfg, shape = shard_cfg(layers), SHAPES_BY_NAME[cell]
    c, s = D.trace_partitioned(cfg, shape, make_production_mesh(),
                               chunks=chunks)
    with open(out, "w") as f:
        json.dump({"flops": c.flops, "bytes": c.bytes,
                   "coll_bytes": c.coll_bytes, "argument": c.argument_bytes,
                   "peak": c.peak_live_bytes,
                   "peak_blocks": c.peak_block_bytes, "trace_s": s}, f)


def shard_card_worker(cell, out, device="cuda", chunks=None, layers=None):
    """Phase 21 (b), the card: rank 0's share of ``cell`` on pod16x16 under
    a fake group of 256 ranks, its local shards allocated on the card (from
    a generator; the fake collectives move nothing, so the values computed
    are not a model's), run once, then counted under the dry run's mode,
    then timed (``device="cpu"``: a CPU rehearsal, no memory or time of a
    card)."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.analysis.counters import storage_bytes
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_device_mesh, make_production_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import use_mesh
    from repro_torch.train.step import materialize
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, shape = shard_cfg(layers), SHAPES_BY_NAME[cell]
    sizes = make_production_mesh()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes.values()))
    try:
        moe.DISPATCH_GROUPS = sizes["data"]
        mesh = make_device_mesh(sizes, device=device)
        fn, args = D.build_cell(cfg, shape, chunks=chunks, device="meta",
                                mesh=mesh)
        args = materialize(args, device,
                           torch.Generator(device=dev).manual_seed(0))
        live = storage_bytes(args)
        live_blocks = storage_bytes(args, blocks=True)

        def step():
            with torch.set_grad_enabled(shape.kind == "train"), \
                    use_mesh(mesh):
                fn(*args)

        def held():
            """(allocated, requested) bytes now: the allocator's blocks
            and the bytes the program asked for (the tracker's raw terms)."""
            _sync(torch, dev)
            if not cuda:
                return 0, 0
            st = torch.cuda.memory_stats()
            return (st["allocated_bytes.all.current"],
                    st["requested_bytes.all.current"])

        def peaks(base):
            """The peaks (allocated, requested) since the last reset, less
            ``base`` (``held()`` then), the arguments counted in again."""
            _sync(torch, dev)
            st = torch.cuda.memory_stats()
            return (st["allocated_bytes.all.peak"] - base[0] + live_blocks,
                    st["requested_bytes.all.peak"] - base[1] + live)

        # a first step also allocates what the libraries then keep (a
        # cuBLAS workspace for each thread that runs a GEMM): the
        # prediction is of a step, so the counted step is the second
        base = held()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        step()
        kept = held()[0] - base[0]
        cold = peaks(base)[0] if cuda else 0
        base = held()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        c = D.run_counted(fn, args, shape.kind, mesh)
        peak, requested = peaks(base) if cuda else (c.peak_block_bytes,
                                                    c.peak_live_bytes)
        times = []
        for _ in range(SHARD_TIMED):
            a, b = _events(torch, dev)
            a.record()
            step()
            b.record()
            _sync(torch, dev)
            times.append(a.elapsed_time(b))
        with open(out, "w") as f:
            json.dump({"flops": c.flops, "bytes": c.bytes,
                       "coll_bytes": c.coll_bytes,
                       "argument": c.argument_bytes, "live": live,
                       "peak": peak, "requested_peak": requested,
                       "cold_peak": cold, "kept": kept,
                       "max_allocated": (torch.cuda.max_memory_allocated()
                                         if cuda else 0),
                       "tracker_peak": c.peak_live_bytes,
                       "counted_s": c.seconds, "ms": times,
                       "k_launches": k_launches()}, f)
    finally:
        dist.destroy_process_group()


def _shard_peak(m, c):
    """(b): the card's allocator peak against meta's predicted peak of
    allocator blocks, relative, and the words that log both peaks."""
    rel = c["peak"] / m["peak_blocks"] - 1
    return rel, (
        f"peak {m['peak_blocks']} B ({m['peak_blocks'] / 2**30:.3f} GiB) of "
        f"allocator blocks predicted, {c['peak']} B allocated on the card "
        f"(max_memory_allocated), {rel * 100:+.4f}%; requested "
        f"{c['requested_peak']} B against the tracker's {m['peak']} B, "
        f"{(c['requested_peak'] / m['peak'] - 1) * 100:+.4f}%; the first "
        f"step {c['cold_peak']} B, leaving {c['kept']} B")


def phase_sharded(torch, card_line):
    """Phase 21: slice L's partitioned step (see the module docstring).
    Every part runs in child processes: this process makes no group.
    Returns K1-K4's launches on the phase's paths (the children's)."""
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase21_")
    n = torch.cuda.device_count()
    rec = {"cells": {}}
    # (b)'s predictions on meta, all cells at once, beside (a)
    t_meta = time.perf_counter()
    outs = {cell: os.path.join(tmp, f"meta_{cell}.json")
            for cell in SHARD_CELLS}
    metas = [_shard_child("shard_meta_worker", (cell,), outs[cell])
             for cell in SHARD_CELLS]
    # (a) a real group over every visible card
    init = os.path.join(tmp, "nccl_init")
    out_a = os.path.join(tmp, "real.json")
    t0 = time.perf_counter()
    procs = [_shard_child("shard_real_worker", (r, n, init), out_a,
                          {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
             for r in range(n)]    # deterministic cuBLAS for bit-equality
    try:
        _shard_wait(procs, t0, "rank")
    except BaseException:
        for q in metas:
            q.kill()
        raise
    with open(out_a) as f:
        a = json.load(f)
    rec["real"] = a
    log(f"phase 21 (a) {SHARD_ARCH} at full width, {SHARD_LAYERS} of 32 "
        f"layers ({'fp32' if a['fp32'] else 'bf16'}), mesh {a['mesh']} over "
        f"{n} card(s), nccl: {SHARD_STEPS} train steps at B={SHARD_B}, "
        f"T={SHARD_T}, a {SHARD_PROMPT}-token prefill and {SHARD_DECODE} "
        f"greedy decode steps, against the one-card program from the same "
        f"seed in the same process; {time.perf_counter() - t0:.1f}s")
    log(f"phase 21 (a) losses (loss, grad_norm) {a['losses']}; partitioned "
        f"step ms {[round(x, 3) for x in a['ms']['partitioned']]}, one card "
        f"{[round(x, 3) for x in a['ms']['one card']]} (CUDA events; the "
        f"last step of each under the counting mode); FLOPs of that step "
        f"{a['flops']}; peak "
        f"{a['peak_gib']['partitioned']:.2f} / "
        f"{a['peak_gib']['one card']:.2f} GiB; collectives of one step "
        f"{a['coll_n']} = {a['coll_bytes']} B (the reference's rule); "
        f"{card_line}")
    log(f"phase 21 (a) against one card: loss rel err {a['loss_err']:.3g} "
        f"(equal: {a['loss_equal']}), sampled leaves {a['leaf_err']}, "
        f"logits {a['logit_err']:.3g}, tokens equal {a['tokens_equal']}")
    if n == 1:
        if not (a["loss_equal"] and a["tokens_equal"]
                and a["logit_err"] == 0
                and all(v == 0 for v in a["leaf_err"].values())):
            raise AssertionError("phase 21 (a): the 1x1 mesh is not "
                                 "bit-equal to the one-card program")
    elif not (a["loss_err"] <= SHARD_REL and a["logit_err"] <= SHARD_REL
              and max(a["leaf_err"].values()) <= SHARD_REL
              and a["tokens_equal"]):
        raise AssertionError(f"phase 21 (a): beyond {SHARD_REL} of one card")
    # (b) rank 0 of pod16x16: each cell the dry run says fits, on the card
    launches = dict(a["k_launches"])
    _shard_wait(metas, t_meta, "meta")
    for cell in SHARD_CELLS:
        with open(outs[cell]) as f:
            m = json.load(f)
        t0 = time.perf_counter()
        out_c = os.path.join(tmp, f"card_{cell}.json")
        if m["peak"] > 80e9:
            log(f"phase 21 (b) {cell}: the dry run predicts a peak of "
                f"{m['peak'] / 1e9:.2f} GB a device: does not fit in 80 GB; "
                f"not run on the card")
            rec["cells"][cell] = {"meta": m, "fits": False}
            continue
        pc = _shard_child("shard_card_worker", (cell,), out_c,
                          SHARD_ALLOC_ENV)
        _shard_wait([pc], t0, "card")
        with open(out_c) as f:
            c = json.load(f)
        for k, v in c["k_launches"].items():
            launches[k] = launches.get(k, 0) + v
        rec["cells"][cell] = {"meta": m, "card": c,
                              "s": time.perf_counter() - t0}
        rel, peak_text = _shard_peak(m, c)
        log(f"phase 21 (b) {SHARD_ARCH} {cell}, rank 0 of pod16x16 (fake "
            f"group of 256; full width and depth; a rehearsal of one rank's "
            f"share, its values not a model's): FLOPs {m['flops']} on meta, "
            f"{c['flops']} on the card; collective bytes {m['coll_bytes']} "
            f"on meta, {c['coll_bytes']} on the card; argument bytes "
            f"{m['argument']} predicted, {c['live']} live; {peak_text}; step "
            f"{[round(x, 3) for x in c['ms']]} ms by CUDA events: compute "
            f"of one rank, no communication; meta trace {m['trace_s']:.1f}s; "
            f"{card_line}")
        if c["flops"] != m["flops"] or c["coll_bytes"] != m["coll_bytes"]:
            raise AssertionError(f"phase 21 (b) {cell}: card and meta "
                                 f"counts differ")
        if c["argument"] != m["argument"] or abs(rel) > SHARD_PEAK_REL:
            raise AssertionError(f"phase 21 (b) {cell}: arguments "
                                 f"{c['argument']} vs {m['argument']}, "
                                 f"peak {rel * 100:+.3f}%")
    if not any("card" in v for v in rec["cells"].values()):
        raise AssertionError("phase 21 (b): no cell ran on the card")
    rec["launches"] = launches
    rec["s"] = time.perf_counter() - t_phase
    log(f"phase 21 {rec['s']:.1f}s; K1-K4 launches in its processes "
        f"{launches}; {card_line}")
    return rec


MB_MICROBATCH = 2               # 22 (a): rows a microbatch of SHARD_B
MB_CELL = "train_4k"            # 22 (b), (e): rank 0 of pod16x16
MB_DIV = 4                      # 22 (b): hillclimb's microbatch4
MB_LAYERS = SHARD_LAYERS        # 22 (b): depth cut for the phase's time
MB_VARIANTS = ("baseline", "microbatch4")   # 22 (e)
MB_BREAKDOWN_LAYERS = 2         # 22 (e): coll_breakdown's default depth
MOE_EX_ARCH = "dbrx-132b"       # 22 (c): the example's routings at full width
MOE_EX_TOKENS = (1, 4096)
MOE_EX_M_TILE = 128
MOE_EX_BF16_REL = 2.0 ** -6     # 22 (c): tests/test_torch_moe.py's bf16 bound
TUNE_CLI_REPEATS = 3            # 22 (d): the CLI's default
TUNE_CLI_RUNS = (("accel", "20000,100000,0", "K1"),
                 ("auto", "20000,100000,0", "K3"),
                 ("auto", "12000,60000,0", "K2"))


def mb_scripts_worker(hw, out):
    """Phase 22 (e), on meta: ``coll_breakdown``'s rows and hillclimb's
    records for ``MB_CELL`` (rank 0 of pod16x16), the terms against the
    card's row ``hw``."""
    from repro_torch.analysis import counters
    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.scripts import coll_breakdown, hillclimb
    cfg, shape = get_config(SHARD_ARCH), SHAPES_BY_NAME[MB_CELL]
    walk, spent = counters._collective_source, [0.0, 0]

    def timed_walk():      # the counting mode's stack walk, timed
        t = time.perf_counter()
        try:
            return walk()
        finally:
            spent[0] += time.perf_counter() - t
            spent[1] += 1

    t0 = time.perf_counter()
    counters._collective_source = timed_walk
    try:
        rows, counts = coll_breakdown.breakdown(
            cfg.replace(n_layers=MB_BREAKDOWN_LAYERS), shape)
    finally:
        counters._collective_source = walk
    res = {"rows": [[list(k), b] for k, b in rows],
           "coll_bytes": counts.coll_bytes, "trace_s": counts.seconds,
           "walk_s": spent[0], "walks": spent[1],
           "breakdown_s": time.perf_counter() - t0, "hillclimb": {}}
    for v in MB_VARIANTS:
        t0 = time.perf_counter()
        rec = hillclimb.measure(cfg, shape, v, hw=hw)
        res["hillclimb"][v] = dict(rec, s=time.perf_counter() - t0)
    with open(out, "w") as f:
        json.dump(res, f)


def moe_example_checks(label, out, ref_rel=None):
    """The example's claims on ``run``'s result: block dispatch dropless
    against the dropless capacity dispatch (within 1e-5; in bf16 within
    ``ref_rel`` of max |ref|) and, for the example itself, a capacity of
    1.25 dropping under skew."""
    for name, r in out.items():
        bound = 1e-5 if ref_rel is None else ref_rel * r["ref_max"]
        log(f"phase 22 (c) {label}, {name}: expert loads {r['loads']}; "
            f"block dispatch vs dropless {r['block_err']:.3e} (bound "
            f"{bound:.3e}), capacity 1.25 vs dropless "
            f"{r['capacity_err']:.3e}")
        if not r["block_err"] <= bound:
            raise AssertionError(f"phase 22 (c) {label}, {name}: block "
                                 f"dispatch {r['block_err']} off the "
                                 f"dropless answer (bound {bound})")
    if ref_rel is None and not out["skewed routing"]["capacity_err"] > 0:
        raise AssertionError(f"phase 22 (c) {label}: capacity 1.25 dropped "
                             f"nothing under skew")


def phase_moe_example(torch, card_line, device="cuda"):
    """Phase 22 (c): the example on the card, then its routings at
    ``MOE_EX_ARCH``'s full MoE width in bf16. Returns K4's launches
    (``device="cpu"``: a CPU rehearsal)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import moe_block_dispatch as ex
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.models.moe import init_moe
    dev = torch.device(device)
    t0 = time.perf_counter()
    total = 0
    for label in ("the example", MOE_EX_ARCH):
        grouped_matmul.launches = 0
        grouped_matmul.launches_by_instance = {"wgmma": 0, "simt": 0}
        if label == "the example":
            out = ex.main(["--device", device])
            inst, ref_rel = "simt", None
        else:
            cfg = get_config(MOE_EX_ARCH)
            gen = torch.Generator(device=dev).manual_seed(0)
            p = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                         device=dev)
            x = torch.randn((*MOE_EX_TOKENS, cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
            out = ex.run(p, x, m_tile=MOE_EX_M_TILE, top_k=cfg.top_k)
            inst, ref_rel = "wgmma", MOE_EX_BF16_REL
            del p, x
        _sync(torch, dev)
        n, by = grouped_matmul.launches, dict(
            grouped_matmul.launches_by_instance)
        want = {"wgmma": 0, "simt": 0}
        want[inst] = 3 * len(out)
        log(f"phase 22 (c) {label}: K4 launches {n} by instance {by} "
            f"(3 per moe_block call, {len(out)} calls); {card_line}")
        if by != want or n != 3 * len(out):
            raise AssertionError(f"phase 22 (c) {label}: K4 launches {by}, "
                                 f"want {want}")
        moe_example_checks(label, out, ref_rel)
        total += n
        del out
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(f"phase 22 (c) {time.perf_counter() - t0:.1f}s")
    return total


def phase_tune_cli(torch, card_line, device="cuda"):
    """Phase 22 (d): the tune_partition CLI's ``main`` on the card for
    each of ``TUNE_CLI_RUNS``. Returns K1-K3's launches (``device="cpu"``:
    a CPU rehearsal)."""
    import contextlib
    import io
    from repro_torch.scripts import tune_partition
    total = dict.fromkeys(("K1", "K2", "K3"), 0)
    for backend, graph, kernel in TUNE_CLI_RUNS:
        t0 = time.perf_counter()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):   # the JSON report
            rep = tune_partition.main(["--synthetic", graph, "--backend",
                                       backend, "--repeats",
                                       str(TUNE_CLI_REPEATS), "--device",
                                       device])
        _sync(torch, torch.device(device))
        got = read_launches()
        timed = 1 + sum("time_s" in c for c in rep["candidates"])
        want = dict.fromkeys(total, 0)
        want[kernel] = (1 + TUNE_CLI_REPEATS) * timed
        ranking = sorted((c for c in rep["candidates"] if "time_s" in c),
                         key=lambda c: c["time_s"])
        errors = [c["label"] for c in rep["candidates"] if "error" in c]
        log(f"phase 22 (d) tune_partition --synthetic {graph} --backend "
            f"{backend}: {rep['graph']}; base "
            f"{rep['base']['time_s'] * 1e3:.4f} ms; ranking "
            + ", ".join(f"{c['label']} {c['time_s'] * 1e3:.4f} ms "
                        f"({c['speedup_vs_base']:.3f}x)" for c in ranking)
            + f"; errors {errors}; launches {got}; "
            f"{time.perf_counter() - t0:.1f}s; {card_line}")
        if got != want:
            raise AssertionError(f"phase 22 (d) {backend} on {graph}: "
                                 f"launches {got}, want {want}")
        for k, v in got.items():
            total[k] += v
    return total


def phase_microbatch(torch, card_line, sharded):
    """Phase 22: slice M (see the module docstring); ``sharded`` is phase
    21's record, whose unmicrobatched step (a) is set beside. Returns the
    phase's record with K1-K4's launches on its paths."""
    import tempfile
    from repro_torch.analysis.roofline import hw_for
    from repro_torch.configs import SHAPES_BY_NAME
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase22_")
    n = torch.cuda.device_count()
    mb = SHAPES_BY_NAME[MB_CELL].global_batch // MB_DIV
    # (b)'s predictions and (e) on meta, beside (a)
    cells = {"plain": {}, "microbatched": {"microbatch": mb}}
    t_meta = time.perf_counter()
    outs = {k: os.path.join(tmp, f"meta_{k}.json") for k in cells}
    out_e = os.path.join(tmp, "scripts.json")
    metas = [_shard_child("shard_meta_worker", (MB_CELL,), outs[k],
                          kwargs={"chunks": ch, "layers": MB_LAYERS})
             for k, ch in cells.items()]
    metas.append(_shard_child("mb_scripts_worker", (hw_for("cuda")["name"],),
                              out_e))
    init = os.path.join(tmp, "nccl_init")
    out_a = os.path.join(tmp, "real.json")
    t0 = time.perf_counter()
    procs = [_shard_child("shard_real_worker", (r, n, init), out_a,
                          {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"},
                          {"microbatch": MB_MICROBATCH})
             for r in range(n)]
    try:
        _shard_wait(procs, t0, "rank")
    except BaseException:
        for q in metas:
            q.kill()
        raise
    with open(out_a) as f:
        a = json.load(f)
    plain = sharded["real"]
    log(f"phase 22 (a) {SHARD_ARCH} at full width, {SHARD_LAYERS} layers, "
        f"mesh {a['mesh']} (nccl), B={SHARD_B} in microbatches of "
        f"{a['microbatch']}, T={SHARD_T}: losses (loss, grad_norm) "
        f"{a['losses']}; step ms (CUDA events, the last counted) "
        f"microbatched partitioned "
        f"{[round(x, 3) for x in a['ms']['partitioned']]}, one card "
        f"{[round(x, 3) for x in a['ms']['one card']]}; without "
        f"microbatching (phase 21 (a)) partitioned "
        f"{[round(x, 3) for x in plain['ms']['partitioned']]}, one card "
        f"{[round(x, 3) for x in plain['ms']['one card']]}; peak GiB "
        f"microbatched {a['peak_gib']}, without {plain['peak_gib']}; "
        f"collectives of one step {a['coll_n']} = {a['coll_bytes']} B; "
        f"{time.perf_counter() - t0:.1f}s; {card_line}")
    log(f"phase 22 (a) against the one-card microbatched step: loss equal "
        f"{a['loss_equal']}, sampled leaves {a['leaf_err']}, logits "
        f"{a['logit_err']:.3g}, tokens equal {a['tokens_equal']}")
    if n == 1:
        if not (a["loss_equal"] and a["tokens_equal"]
                and a["logit_err"] == 0
                and all(v == 0 for v in a["leaf_err"].values())):
            raise AssertionError("phase 22 (a): the microbatched 1x1 mesh is "
                                 "not bit-equal to the one-card step")
    elif not (a["loss_err"] <= SHARD_REL and a["logit_err"] <= SHARD_REL
              and max(a["leaf_err"].values()) <= SHARD_REL):
        raise AssertionError(f"phase 22 (a): beyond {SHARD_REL} of one card")
    launches = dict(a["k_launches"])
    # (b) the cut cell without and with microbatching on the card
    _shard_wait(metas, t_meta, "meta")
    b = {}
    for k, ch in cells.items():
        with open(outs[k]) as f:
            m = json.load(f)
        t0 = time.perf_counter()
        out_c = os.path.join(tmp, f"card_{k}.json")
        _shard_wait([_shard_child("shard_card_worker", (MB_CELL,), out_c,
                                  SHARD_ALLOC_ENV,
                                  kwargs={"chunks": ch,
                                          "layers": MB_LAYERS})],
                    t0, "card")
        with open(out_c) as f:
            c = json.load(f)
        for kk, v in c["k_launches"].items():
            launches[kk] = launches.get(kk, 0) + v
        b[k] = {"meta": m, "card": c}
        rel, peak_text = _shard_peak(m, c)
        log(f"phase 22 (b) {SHARD_ARCH} {MB_CELL} {k} ({ch or 'one batch'})"
            f", full width, {MB_LAYERS} of 32 layers, rank 0 of pod16x16 "
            f"(fake group of 256): FLOPs {m['flops']} on meta, {c['flops']} "
            f"on the card; collective bytes {m['coll_bytes']} on meta, "
            f"{c['coll_bytes']} on the card; argument bytes {m['argument']} "
            f"predicted, {c['live']} live; {peak_text}; step "
            f"{[round(x, 3) for x in c['ms']]} ms by CUDA events; meta trace "
            f"{m['trace_s']:.1f}s; {time.perf_counter() - t0:.1f}s; "
            f"{card_line}")
        if c["flops"] != m["flops"] or c["coll_bytes"] != m["coll_bytes"]:
            raise AssertionError(f"phase 22 (b) {k}: card and meta counts "
                                 f"differ")
        if c["argument"] != m["argument"] or abs(rel) > SHARD_PEAK_REL:
            raise AssertionError(f"phase 22 (b) {k}: arguments "
                                 f"{c['argument']} vs {m['argument']}, peak "
                                 f"{rel * 100:+.3f}%")
    peaks = {k: v["card"]["peak"] for k, v in b.items()}
    if not peaks["microbatched"] < peaks["plain"]:
        raise AssertionError(f"phase 22 (b): microbatched peak not below the "
                             f"plain one: {peaks}")
    if b["microbatched"]["card"]["flops"] != b["plain"]["card"]["flops"]:
        raise AssertionError("phase 22 (b): microbatching changed the FLOPs")
    # (e) the scripts' records, from the child beside (a)
    with open(out_e) as f:
        e = json.load(f)
    log(f"phase 22 (e) coll_breakdown {SHARD_ARCH} {MB_CELL} baseline "
        f"({MB_BREAKDOWN_LAYERS} layers, rank 0 of pod16x16, meta, "
        f"{e['breakdown_s']:.1f}s); top rows:")
    log(f"phase 22 (e) the source of each collective: {e['walks']} stack "
        f"walks took {e['walk_s'] * 1e3:.3f} ms of the {e['trace_s']:.3f} s "
        f"trace ({e['walk_s'] / e['trace_s'] * 100:.4f}%)")
    for (kind, dtype, src), n in e["rows"][:10]:
        log(f"  {n / 1e9:10.3f} GB  {kind:14s} {dtype:5s} {src}")
    per_kind = {}
    for (kind, _, _), n in e["rows"]:
        per_kind[kind] = per_kind.get(kind, 0) + n
    if per_kind != e["coll_bytes"]:
        raise AssertionError(f"phase 22 (e): breakdown rows {per_kind} do "
                             f"not sum to the count {e['coll_bytes']}")
    for v, r in e["hillclimb"].items():
        log(f"phase 22 (e) hillclimb {v}: terms "
            f"{ {k: round(x * 1e3, 3) for k, x in r['terms'].items()} } ms "
            f"against {r['hw']}, bottleneck {r['bottleneck']}, useful "
            f"{r['useful']:.4f}; cost {r['cost']}; {r['s']:.1f}s")
    # (c) and (d) in this process
    k4 = phase_moe_example(torch, card_line)
    tune = phase_tune_cli(torch, card_line)
    rec = {"real": a, "cells": b, "scripts": e,
           "launches": launches, "moe_example": k4, "tune_cli": tune,
           "s": time.perf_counter() - t_phase}
    log(f"phase 22 {rec['s']:.1f}s; K1-K4 launches in its child processes "
        f"{launches}; {card_line}")
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs the port on a GPU")
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "__init__.py")):
        raise RuntimeError(f"no repro_torch package under {SRC}")
    sys.path.insert(0, SRC)
    t0 = time.perf_counter()
    name, card_line = phase_card(torch)
    phase_build()
    dev = torch.device("cuda")
    float_err = phase_kernel_cases(torch, dev)
    graphs, engine, launches_a = phase_serve(torch, dev)
    phase_profile(torch, engine, graphs)
    engine.close()
    small, small_engine, launches = phase_routed(torch, dev, graphs,
                                                 engine.cache)
    small_engine.close()
    # K1's record keeps slice A's path count; K2 and K3 report slice B1's
    launches["K1"] = launches_a
    k1, k3 = phase_timing(torch, graphs, engine, launches, float_err)
    phase_timing_resident(torch, small, small_engine)
    k2 = phase_timing_k2(torch, small, small_engine, launches,
                         float_err["K2"])
    fleet, _ = phase_fleet(torch, dev, graphs, small)
    del graphs, engine, small, small_engine
    gc.collect()
    torch.cuda.empty_cache()                # the GCN phases' memory goes
    peak = torch.cuda.max_memory_allocated()  # phase 8 resets the peak
    train = phase_train(torch, dev, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    mutate = phase_mutate(torch, dev, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    tune = phase_tune(torch, dev, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    sample = phase_sample(torch, dev, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    # the workers share the card: this process holds no phase's tensors
    multihost = phase_multihost(torch, card_line)
    witnessed, _ = phase_witness(torch, card_line)
    k1["launches_by_path"] = {"serve": launches_a,
                              "train": train["launches"],
                              "mutate": mutate["K1"], "tune": tune["K1"],
                              "sample": sample["K1"], "fleet": fleet["K1"],
                              "multihost": multihost["K1"],
                              "witness": witnessed["K1"]}
    k2["launches_by_path"] = {"routed": launches["K2"],
                              "fleet": fleet["K2"],
                              "multihost": multihost["K2"]}
    k3["launches_by_path"] = {"routed": launches["K3"],
                              "mutate": mutate["K3"], "fleet": fleet["K3"],
                              "multihost": multihost["K3"]}
    for rec, k in ((k2, "K2"), (k3, "K3")):
        for path, counts in (("sample", sample), ("witness", witnessed)):
            if counts[k]:
                rec["launches_by_path"][path] = counts[k]
    k4_err = phase_k4_cases(torch, dev)
    p, p32, xs, x32, metas, k4_launches = phase_moe(torch, dev)
    k4 = phase_timing_k4(torch, p, p32, xs, x32, metas, k4_launches, k4_err)
    peak = max(peak, torch.cuda.max_memory_allocated())
    del p, p32, xs, x32, metas
    gc.collect()
    torch.cuda.empty_cache()
    lm_before = k_launches()
    lm_rec = phase_lm(torch, card_line)          # resets the peak
    peak = max(peak, torch.cuda.max_memory_allocated())
    gc.collect()
    torch.cuda.empty_cache()
    lm_mid = k_launches()
    train_lm = phase_train_lm(torch, card_line)    # resets the peak
    peak = max(peak, train_lm["peak_gib"] * 2**30)
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(torch, card_line, lm_rec["dryrun"] + [train_lm["dryrun"]])
    lm_after = k_launches()
    sharded = phase_sharded(torch, card_line)
    micro = phase_microbatch(torch, card_line, sharded)
    k4["launches_by_path"] = {"moe": k4["launches"],
                              "moe_example": micro["moe_example"]}
    for rec, k in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        rec["launches_by_path"]["tune_cli"] = micro["tune_cli"][k]
    for rec, k in ((k1, "K1"), (k2, "K2"), (k3, "K3"), (k4, "K4")):
        rec["launches_by_path"]["lm"] = lm_mid[k] - lm_before[k]
        rec["launches_by_path"]["lm_train"] = lm_after[k] - lm_mid[k]
        rec["launches_by_path"]["lm_sharded"] = sharded["launches"].get(k, 0)
        rec["launches_by_path"]["lm_microbatch"] = micro["launches"].get(k, 0)
    log(f"peak device memory {peak / 2**30:.2f} GiB; total "
        f"{time.perf_counter() - t0:.1f}s")
    records = [k1, k2, k3, k4]
    print(json.dumps({"kernels": records}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — any failed phase fails the run
        import traceback
        traceback.print_exc()
        print(f"[chip_smoke] FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
