#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA GPU and check what comes out.

Usage (from the repository root, on a machine with one NVIDIA H100 and the
CUDA toolkit under /usr/local/cuda or $CUDA_HOME)::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA kernel of the port from ``csrc/`` (``nvcc``, all
   sources at once) and print the build seconds;
3. every kernel against its plain PyTorch version on the card, over a
   sweep of shapes and at the shapes the main path gives it, with kernel,
   plain, library-call and lower-bound times: the fused ``spmv`` kernel in
   float32 and float64, unweighted and weighted, on edge-case graphs (E
   around the scan's tile, empty leading and trailing rows, one hub row
   over more than 32 tiles), the 300-node power-law graph and the main
   path's graph, timed at the main path's shapes against the plain
   version, the composite around ``cumsum`` and
   ``torch.sparse_csr_tensor @ w``; ``cumsum`` timed at the ``hybrid``
   tail's length, whose run launches it, and swept over lengths around its
   tile and at ``cumsum_mxu``'s base case; two calls of ``cumsum`` and of
   ``spmv`` on one input must agree bit for bit (``spmv`` and ``segment``
   twice through the input's plan and twice without one), and so must
   kernel and plain version on small integers, whose sums are exact;
   ``rowsum`` also over widths 1 to 1000, row counts around one block's
   run of rows and one wave, and unaligned row slices, in float32 and
   float64, and timed beside its scalar loop; the ``segment`` kernel (the
   sorted segmented sum) through both its loaders in float32 and float64,
   unweighted and weighted, over edge cases (no rows, no values, sizes
   around its block of merge-path items, a hub row over 150 blocks amid
   empty rows, long runs of empty rows, every row ending a block), the
   spmv sweep's graphs and the main path's, float32 rows within 1 ulp and
   float64 rows within 1e-12 of the row's sum of |x| of plain, integers
   equal, two calls equal, then timed at the main path's shapes against
   its plain float64 ``index_add_`` and ``torch.segment_reduce``, and at the
   ``hybrid`` head's and ``sort_shuffle``'s shapes with their bounds (each
   call site also timed without a plan); its widened entry (float32 in,
   float64 out, the ``owned`` head's partials) at the main path's shape
   and at the ``owned`` head's of 16b's 4-slot partition, bit for bit
   equal to its plain version, its rows rounded to float32 equal to the
   float32 entry's, timed beside it; the plans' tile sizes and
   scratch against the kernels'; and, once, the launch floor of the
   timing protocol;
3b. the gather kernel of the SpMV cost probe against its plain version,
   bit for bit, in every mode of the probe at its default shapes (timed
   beside the L2 loop alone), at edge shapes, and on both sides of each
   width limit of the staged route;
3c. the put's derivation (``csrc/put.cu``: ``spmv_rows``, ``expand_dst``,
   ``segment_coords``, ``node_vectors``) at the main path's graph and the
   300-node graph, each wrapper on the card bit for bit equal to its plain
   version on the same inputs and to the numpy builder the CPU put runs,
   ``node_vectors`` from the out-degree and from a float64 out-strength in
   float32 and float64; each timed at the main path's shapes against its
   plain version, one library call where one computes the same
   (``torch.searchsorted``, ``torch.repeat_interleave``) and its byte
   bound;
4. the main path, ``run_pagerank`` at web-Google scale (875K nodes, 5.1M
   edges, 20 iterations), through the ``segment``, ``pallas`` and
   ``hybrid`` SpMV impls, checked against an f64 run and counting kernel
   launches (``segment`` launches the segment kernel, ``hybrid`` the
   ``cumsum`` and segment kernels, 20 times or more each; the put of each
   run ``node_vectors`` and ``segment_coords`` once, of ``segment`` and
   ``pallas`` also ``spmv_rows`` and ``expand_dst`` once) and the
   plans built (one a pointer array, at ``put_graph``: a run builds what one
   ``put_graph`` builds); every impl is also held against a dense f64
   power iteration on a small graph; the ``pallas`` loop's profile must
   show no index widening, ``cat`` or index kernel, the ``segment`` loop's
   no ``index_add_``; neither shows ``segment_fixup``, ``row_diff`` or a
   memset beyond the loop's own, and each stays below the device ops a
   step of its two- and three-op calls (11.3 and 12.3);
4d. every SpMV impl, and ``spark_exact``, run twice at full width in
   float32 and float64: all but ``bcoo`` (the library's sparse product)
   must give equal bits;
5. the port's CLI once, at the same scale, with ``--trace-dir`` and
   ``--profile-dir``: its output file checked, its trace read back by
   ``tools/trace_report.py`` with the ``pagerank.result_pull`` span, its
   Chrome trace holding that span and the card's kernels;
6a. the three SpMV cost probes (``tools/gather_micro``, ``xla_cost_micro``,
   ``spmv_breakdown``) through their ``main`` at default sizes, each
   record checked for its stamp, the JAX tool's keys and its times;
6b. ``torch.profiler`` over the breakdown's ``gather_w_src`` stage alone,
   its kernels and host ops by name;
8. batch TF-IDF, which reaches no kernel, at BASELINE config 2's size (the
   19,000-document stand-in for 20-Newsgroups, vocab 2^18): the corpus
   tokenized by the C++ tokenizer (the run fails on the numpy path);
   ``api.tfidf`` in the default configuration, cold and a warm median of
   5, tokens/s, no kernel launched, and a ``torch.profiler`` line of the
   pipeline's device time by op and busy share; ``ops.tfidf_pipeline`` in
   all 18 TF x IDF x L2 modes against a float64 numpy oracle (COO, counts
   and DF equal, IDF and weights within 2e-6), each L2 mode twice, equal
   bit for bit; ``score_query`` top-10 against the oracle's stable order;
   the TF-IDF CLI (``python -m``) against ``api.tfidf`` on the tiny
   fixture; and the PageRank loaders' native parse and sort against their
   numpy paths, on the tiny fixture and on the main path's graph;
9. streaming TF-IDF, which reaches no kernel either: (9a)
   ``ops.tfidf.chunk_counts_carry`` on the card against the CPU on the same
   padded chunks (a real one, one with no valid token, one whose every
   token is its own pair), outputs and carry equal; (9b) the config-2
   stand-in in chunks of 512 documents re-packed and padded to 2^18 tokens
   (``bench.py``'s streaming knobs), serial (``prefetch`` 0,
   ``pipeline_depth`` 0) and pipelined (2, 2), raw/classic and smooth/L2:
   the COO sorted by (term, doc), counts, weights, DF and IDF equal to
   ``run_tfidf``'s on the card bit for bit, with tokens/s, chunks, cap
   bumps and ``h2d_overlap_frac`` beside the batch path's tokens/s and the
   host's part alone (packing, then tokenizing the packed chunks); (9c)
   the config-5 stand-in (100,000 documents, bigrams, about 36M tokens),
   pipelined, checked the same way; (9d) ``torch.profiler`` over one
   pipelined config-2 run: every chunk's copy ``Pinned -> Device`` on a
   stream other than the sort's, and the device's busy share; (9e) a run
   whose source dies after chunk 10, checkpointing every 4, resumed: equal
   to an unbroken run bit for bit; no kernel of the port launches;
10. the servable index: ``cli.tfidf --streaming --save-index`` on the
   config-2 stand-in, read back by ``serving.load_index``, every array equal
   to ``save_index`` of ``api.tfidf``'s output, BM25 weights within 2e-6
   of float64 numpy;
11. serving, which reaches no kernel but the prior's: (11a) the config-2
   stand-in's index (counts, BM25, a prior from ``run_pagerank``
   ``segment``, whose launches are counted) served by ``TfidfServer`` at
   every batch cap, COO and impacted, for every ranker, 2,048 corpus
   queries: impacted equal to COO, every cap to cap 8, two runs equal,
   served equal to the one-shot ``score_query``, the CPU's bits, all bit
   for bit, and the float64 oracle's top-10 (scores within 2e-6, ids
   wherever it sets them apart); no kernel launched while scoring; whether
   ``doc_sums`` adds left to right on the card; (11b) the server with
   ``ServeConfig()`` defaults under four closed-loop clients, both
   scorings: queries/s, latency p50/p99, queue wait, a second pass all LRU
   hits, dispatch device ms by cap, the device's busy share of 50 batches,
   and a ``set_prior`` under traffic equal to the one-shot score plus the
   new prior; (11d) ``cli.serve`` from a file and from stdin with
   ``GRAFT_METRICS_PORT=0``, lines equal to the server's, the
   ``serve.latency_s`` histogram on ``/snapshot.json``; (11c) the
   config-5 stand-in (bigrams, smooth/L2) sealed as four segments and
   served against a monolithic index, then ``merge_once`` and
   ``refresh_segments`` under traffic, results unchanged bit for bit;
12. PageRank checkpoints and the graph workloads on the main path's graph:
   (12a) for ``segment``, ``pallas`` and ``hybrid`` in float32 and float64,
   a run killed at 10 iterations with a checkpoint every 5 and resumed to
   20, its ranks equal to an unbroken run's bit for bit and its launches
   those of 15 steps; the CLI the same way (``--checkpoint-dir``,
   ``--checkpoint-every 5``, then ``--resume``), its lines against the API's
   ranks; the 20-iteration run with and without checkpoints, medians of 5;
   (12b) ``run_ppr_batch`` at bench.py's shape (8 single-node queries from
   seed 7, 10 iterations) through ``cumsum``, ``segment``, ``pallas`` and
   ``hybrid``: float64 rows within 1e-12 of single-query ``run_pagerank``,
   float32 rows within L1 1e-3 of float64, the API's run and five timed
   runs equal bit for bit, queries/s, launches by kernel (8 a step of each
   of the impl's kernels); (12c) ``run_hits``, 100 iterations at tol 1e-8,
   float32 and float64, five runs equal bit for bit, two ``segment``
   launches a step and no other, float64 within 1e-12 of the CPU run,
   iterations/s; (12d) ``run_components`` to its fixpoint on that graph and
   on a sparse one of many components, labels equal to scipy's weak
   components relabelled to each one's smallest id, rounds/s, no kernel
   launched; (12e) ``cli.workloads`` ``ppr``, ``hits`` and ``cc``
   once each on a small graph, lines equal to the API's;
13. chaos on the card, faults injected with ``resilience.chaos.inject`` at
   the guarded sites: (13a) ``segment``, ``pallas`` and ``hybrid`` in
   float32 and float64, a checkpoint every 5, under ``pagerank_step:fail@2``,
   ``pagerank_ckpt_pull:fail@1``, ``pagerank_result_pull:fail@1`` and
   ``*:fail@%3``: ranks equal to the unfaulted run bit for bit, one
   ``retry`` event per injection, the unfaulted run's launches; (13b) HITS
   (tol 1e-8) on a side stream, three runs under
   ``hits_delta_sync:hang@3:2.0`` with ``GRAFT_SYNC_DEADLINE_S=0.5``: one
   ``watchdog`` event, scores equal to the unfaulted run's and the default
   stream's, the faulted run under 2 s over the unfaulted one;
   (13c) ``pagerank_step:lost@3`` (``segment`` float32): ``ResilienceExhausted``
   naming the iteration-10 checkpoint, ``exhausted`` and no ``degraded``,
   the resumed run equal to the unbroken one; (13d) phase 9's config-2
   stand-in, pipelined, under faults at ``tfidf_chunk_sync``,
   ``ingest_h2d_put``, ``ingest_h2d_wait`` and ``tfidf_df_commit``: equal
   to batch bit for bit, and a source that dies at chunk 5 raises once,
   unretried; (13e) phase 11b's index, 2,048 queries under
   ``serve_dispatch:fail@%5;serve_pull:fail@7``: every answer equal to the
   unfaulted server's, no request failed; ``merge_once`` over 11c's four
   segments under ``segment_merge:fail@1`` equal to the unfaulted merge;
   (13f) the median of 10,000 ``run_guarded(lambda: None)`` calls with no
   plan, beside 4b's ``segment`` loop ms and 11b's queries/s;
14. a lost device hands the run to the CPU, on phase 12's inputs: (14a)
   PageRank ``segment`` float32, a checkpoint every 5, under
   ``device_lost@dev:0`` at ``pagerank_step`` (on a run resumed from
   checkpoint 10), ``pagerank_delta_sync``, ``pagerank_ckpt_pull`` and
   ``pagerank_result_pull``, and at the step for ``pallas`` and ``hybrid``
   float32 and ``segment`` float64: one ``degraded`` with ladder ``cpu``
   and the newest snapshot's ``salvage_iter`` (10, 0, 0, 15), no run
   exhausted, the ranks equal bit for bit to ``run_pagerank(device="cpu",
   resume=True)`` from that snapshot and within L1 1e-3 (float64: 20 steps
   of ``segment.cu``'s per-call bar, 2e-11) of the unbroken card run, the
   card's launches those before the loss; (14b) what the salvage does not
   take, at the third segment: ``pagerank_delta_sync:lost@3`` (a
   whole-backend loss) and a runner that raises a CUDA error (a kernel's
   own fault): ``ResilienceExhausted`` naming the iteration-10 checkpoint,
   no ``degraded``, no segment on the CPU, 15 and 10 launches; (14c) PPR
   (``segment``, B = 8), HITS and components under a loss at their delta
   syncs and PPR at its result pull: PPR and HITS equal to their
   ``device="cpu"`` runs bit for bit, labels to scipy's; (14d) the config-2 stream, a checkpoint every 4, under a loss at
   ``ingest_h2d_put`` and at ``ingest_h2d_wait``, and resumed from a
   snapshot of its first two thirds under a loss at ``tfidf_df_commit``
   (``salvage_chunk`` and ``rerun_chunks`` above 0): one ``degraded`` with
   ``rerun_chunks``, COO, counts and DF equal to the card's stream, every
   array to the CPU stream's; (14e) no ``degraded`` event in phases 1-13;
   (14f) each 14a run's wall beside the unbroken card run's,
   and the CPU's iterations/s after the hand-over, with the card's name and
   power limit;
15. tuned profiles (``utils/config.py``'s ladder, ``tools/autotune.py``),
   with the port's committed ``tuned_profile_gpu.json``: (15a) the tuner's
   ``--dry-run`` on the card, the CPU's plan (87 raw points, 45 pruned;
   survivors/pruned by group); (15b) every point of the declared domain's
   layouts on the main path's graph: ``rowsum`` over the ``hybrid`` head at
   ``head_row_width`` 64, 128, 256 and ``head_coverage`` 0.25, 0.5, 0.75,
   the tail's ``cumsum`` and the head's ``segment`` sum there, and
   ``sort_shuffle``'s buckets at widths 4, 8, 16 through ``segment``, each
   against its plain version in float32 and float64 with both times; each
   layout's 20-iteration loop twice per dtype, equal bits, within L1 1e-3
   of ``segment`` in float32 and L1 1e-12 in float64, each of its
   kernels launched once a step; (15c) two sweeps of ``--budget-s 20`` on
   the tuner's probes into temporary paths: every knob in its domain,
   stamped ``gpu`` with the card's name and power limit, each measured
   group's defaults measured first (``owned`` on four slots of the card)
   and left only for a winner whose turns all beat them, a group the
   budget left unmeasured at its defaults (the committed profile too),
   the groups' winners side by side; (15d) the PageRank CLI
   (``hybrid``, full size) with ``--tuned-profile``, with an explicit
   ``--head-row-width`` beside it, under ``GRAFT_TUNED_PROFILE``, with
   ``off`` and with neither (the committed profile): ranks bit-equal to
   ``run_pagerank`` over ``tuned_config`` of the same profile (the
   defaults for ``off``), the file byte-equal, the manifest naming the
   profile's path, source and knobs; a ``cpu`` profile on the card and the
   ``gpu`` profile under ``--device cpu`` raise ``ProvenanceError`` and
   run nothing; the streaming TF-IDF CLI killed and resumed from its
   checkpoint, and the serve CLI (impacted), under the committed profile,
   held to batch and to a server over ``tuned_config``; (15e)
   ``TUNABLE_DEFAULTS`` against the committed profile in turns (D P P D P
   D): config 1 ``hybrid`` iterations/s, the config-2 stream's tokens/s
   (outputs held to batch) and impacted queries/s of 11b's server over
   1,024 queries, medians and spreads, not a claim.  Phases 5, 8, 10, 11d
   and 12a run their CLIs with ``--tuned-profile off``, the setting of the
   API run they are held to;
16. the mesh of slots (``parallel/``), D slots of ``cuda:0`` (the D-shard
   layout on one card, not multi-GPU scaling): (16a) each collective on 1,
   2 and 4 slots against the same collective over CPU tensors, gathers and
   permutes exact, float64 reductions within 1e-12; (16b)
   ``run_pagerank_sharded`` on the main path's graph, 20 iterations, every
   strategy at 4 slots under ``segment`` (``owned`` at 2 too) and
   ``cumsum`` under ``edges`` and ``nodes``: float64 within 1e-9 L1 of the
   single-device float64 run, float32 within L1 1e-3 of it, two float32
   runs equal bit for bit, float32 ``owned`` (4 and 2 slots), ``nodes``
   and ``nodes_balanced`` under ``segment`` equal bit for bit to the
   one-device float32 ``segment`` run (the other strategies' differing
   entries printed), ``segment.cu`` launched at least D x 20 times
   (``cumsum.cu`` under ``cumsum``, ``rowsum.cu`` at least 20 under
   ``hybrid``), iterations/s, partition and put seconds; (16c) ``owned``
   and ``edges`` at 4 slots, a checkpoint every 5, slot 1 lost at the step
   and slot 2 at the rerun: degraded ``mesh_shrink`` 4 -> 2 then
   ``single_device`` 2 -> 1, float64 within 1e-9 L1 of the unbroken run,
   and ``owned`` in float32 under the same plan equal bit for bit to the
   unbroken float32 runs;
   (16d) ``run_tfidf_sharded`` over config 2 at 4 slots against
   ``run_tfidf_streaming``: COO, counts and DF equal, weights within 2e-6,
   whether the bits are equal; (16e) PPR (B = 8), HITS and components at
   4 slots against the single-device runs at phase 12's bars; (16f)
   ``cli.pagerank --mesh 1 --shard-strategy auto`` byte-equal to the API,
   ``--mesh`` past the visible cards failing with the reference's message;
   (16g) one mesh across processes (``parallel.init_distributed``): two
   NCCL processes on the one card raise ``ValueError``; then two spawned
   processes share the card over gloo, two slots each (D = 4), and run
   every strategy in float32 under segment, ``edges`` under cumsum,
   ``nodes`` in float64 and ``owned`` stopped at 10 and resumed from its
   checkpoint, each bit-equal on both processes and to 16b's one-process
   run, iterations/s beside 16b's; TF-IDF (config 2), PPR, HITS and
   components at one slot a process, bit-equal to the one-process mesh of
   two slots; ``segment.cu``, ``rowsum.cu`` and ``cumsum.cu`` launched in
   the processes, counted under ``distributed``; one deadline for the
   group, a process that raises, hangs or dies fails the phase;
17. the serving fleet (``serving/fabric.py``, ``serving/soak.py``): (17a)
   11c's config-5 stand-in sealed as four segments and two replica
   processes on the card behind ``ServingFabric``: each handshake's
   seconds, each replica pid holding the card's device file and its used
   memory before and after (``nvidia-smi`` cannot map the card's processes
   to pids inside a PID namespace; its compute-apps line is printed as it
   is); (17b) phase 11's query generator's 2,048 queries over that corpus
   through the router from four closed-loop clients, every answer within
   11c's bar of an in-process ``TfidfServer`` over the same segments
   (bit-equal answers counted), queries/s, p50/p99, each replica's share
   and own latency, and a repeated request id replayed, not executed;
   (17h) the fabric's CLI (``python -m ...serving.fabric --replica
   --device cuda``): its handshake, its answers to the first 256 queries
   equal to 17b's bit for bit, SIGTERM rc 0; (17c) ``scale_up`` of a
   replica whose environment carries ``replica_query:proc_kill@3``: it dies
   at its third query, every query is answered equal to 17b's, one
   ``degraded`` on the ``respawn`` rung, the respawn's seconds to ready,
   dropped 0, served twice 0, then ``scale_down``; (17e) a non-owner's miss
   served from the owner's cache byte for byte, then two in-process
   replicas on the card: ``cache_peek``/``cache_fill`` partitioned trip the
   breaker, which half-opens and closes once healed; under a 2 s
   ``cache_peek`` hang the p99 stays within the peek deadline of the clean
   p99, both passes timed with the cycle collector held off, as ``timeit``
   times; (17d) ``rolling_restart`` with handoff under four clients: no query
   fails, roll retries 0, the floor at the fleet's generation, the ports
   kept, at most three replica processes on the card; a floor committed
   above the generation: a replica restarted then and the fleet answer
   ``/healthz`` 503 until the new generation lands; (17f) ``run_soak`` on
   the card at ``tests/test_soak.py``'s settings: the reference's record
   keys, dropped 0, served twice 0, one recovery, ``segment`` launched by
   the prior (counted), one prior refresh within phase 4's float32 bar of
   ``device="cpu"``; (17g) ``run_fleet_soak`` with two replicas on the card
   at ``tests/test_fabric.py``'s rates (respawns, rolled 2, the roll ok,
   the floor), over 45 s with the kill at 5 s and the roll at 30 s, sized
   to the card's respawn: ``time_to_recover_s`` not null, dropped 0,
   served twice 0, roll retries 0, with the root ``tools/slo_watch.py
   --once --fleet`` against its router meanwhile;
18. the port's static analysis and its wire-protocol harness: (18a)
   ``python -m ..._torch.analysis`` over the tree as shipped, one process
   a tier (1; 2, the traced steps; 3 with ``--cost-report``; 4 with
   ``--lock-graph``; 5 with ``--crash-points``; 6 with ``--wire-probes``),
   all started together, each exiting 0 with no finding under the empty
   baseline, its findings and seconds printed;
   (18b) ``tools/protocol_harness.py`` with its replica and the router on
   ``cuda:0``: every probe of the declared message space answered within
   its timeout with a declared code, a duplicate request id leaving the
   replica's ``executions`` unmoved, ``double_served == 0``, a stale floor
   ending in a typed ``FabricExhausted``; the probe count, the handshake
   and harness seconds printed beside the card's name and power limit;
   (18c) each main-path entry of the registry (``pagerank_step``,
   ``_pallas``, ``_hybrid``, ``_sort_shuffle``, ``pagerank_rowsum_pallas``)
   at the web-Google stand-in's shape on ``cuda:0``: traced on fake
   tensors, then one real step, whose launches of each kernel equal that
   kernel's op nodes in the trace; the step again under
   ``torch.cuda.set_sync_debug_mode("error")`` wherever the trace counted
   no host read; the modelled bytes and FLOPs a step printed beside the
   step's measured device ms;
19. the port's CI and chaos gates on the card: (19a) each scenario of
   ``..._torch/tools/chaos_scenarios.py`` on ``cuda:0`` but the crash
   harness's (its workers touch no device): the 2-slot mesh of ``cuda:0``
   losing slot 1 (PageRank sharded, TF-IDF sharded and ``owned`` within
   1e-6 of the unbroken run, three ``mesh_shrinks`` 2 -> 1, nothing
   exhausted), the tolerance fixpoint and batched PPR, the staged ingest,
   the segment hot swap (every request served once), then with the
   replicas on ``cuda:0`` malformed messages at a faulted fleet, the scrape
   partition and hang, the cache-peer partition and hang (dropped 0,
   served twice 0, roll retries 0); (19b) the owned-strategy and segment
   smokes of ``..._torch/tools/ci_smokes.py`` on the card, within the
   reference's budgets; each scenario's and smoke's bars and seconds
   printed, and the kernels' launches over the phase (``segment`` above 0);
20. the reference's last drivers on the card: (20a)
   ``..._torch/tools/dryrun.dryrun_multichip(4)`` (4 slots of ``cuda:0``, or
   one slot a card where four are visible): every strategy on the tiny
   graph and the sharded TF-IDF, then the owned-scale sweep at the
   reference's defaults (Zipf graphs of 875,000, 3,500,000 and 8,750,000
   nodes at 5.83 edges a node, built by the sweep's generator in one
   process started after phase 1, while the phases between run): each
   point's float32 ``owned`` equal to one device bit for bit and its
   float64 within 1e-9 L1, the comm-bytes exponent below 1, the
   top scale's replicated state past half of 256 MiB and
   ``auto_select_strategy`` -> ``owned``, each point's record
   (build, partition and put seconds, iterations/s, the rank sum,
   ``max_memory_allocated``, the float64 head psum's bytes) printed; (20b)
   ``..._torch/tools/streaming_rehearsal.py`` at its defaults (1,000,000
   documents, bigrams, a checkpoint every 32 chunks) as its own process:
   ``n_docs``, ``n_tokens`` equal to the generator's corpus counted on the
   host, 3 checkpoints over 123 chunks, the 1/8-scale serial and pipelined
   runs equal bit for bit, tokens/s, ingest and finalize seconds, peak RSS
   and the pipeline speedup printed; (20c) ``examples/torch_pagerank_example.py``,
   ``torch_tfidf_example.py`` and ``torch_multichip_example.py`` as
   processes on the card, each exiting 0, the multichip example's L1
   against one device at most 1e-9 for every strategy; the kernels'
   launches over 20a and 20b (``segment``, and ``rowsum`` under
   ``hybrid``);
7. one JSON line describing every kernel (with ``workload_launches``, each
   kernel's launches in 12a-12c, 13a-13c, 14, 15b, 16, 17f-17g, 18b, 18c,
   19 and 20 by workload; for the put's kernels, whose launches only 4b
   counts, null), then the result line.

Without a CUDA device, or without the port's package beside it, it exits
non-zero and prints no result.  ``python3 chip_smoke.py --cards`` on a
machine with four or more cards runs phase 16 alone with one slot a card,
16g as one process a card over NCCL; ``python3 chip_smoke.py --fleet``
runs phase 17 alone, ``python3 chip_smoke.py --analysis`` phase 18,
``python3 chip_smoke.py --ci`` phase 19 and ``python3 chip_smoke.py
--drivers`` phase 20.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import _build  # noqa: E402
from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.timing import (  # noqa: E402
    BOUND_SLACK,
    bound_ms,
    card,
    time_ms,
)

# Tolerances of a kernel against its plain version on the same input.
# cumsum: |kernel - plain| <= rtol * (running sum of |x|); the two sum in
# different orders, and in float32 that is the prefix-sum accuracy class
# of the JAX package's spmv_cumsum (about 2e-4 relative per SpMV).
# rowsum: |kernel - plain| <= rtol * (row sum of |x|).
CUMSUM_RTOL = {torch.float32: 2e-4, torch.float64: 1e-12}
ROWSUM_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# spmv: out[v] is a difference of two prefix sums, each rounded along its own
# association tree (kernel and torch.cumsum), so |kernel - plain| at row v is
# held to SPMV_ULPS units u of the running sums of |per-edge| at the row's
# two ends, C[indptr[v]] + C[indptr[v+1]], with u the unit roundoff; the
# sum over rows of |kernel - plain| to SPMV_L1_ULPS units of the sum of those
# scales.  A row set to zero or moved can hide under that at the end of a
# long array, so every graph is also run on small integers, whose prefix sums
# are exact in either type: there the kernel must equal the plain version,
# and the float64 sum, bit for bit.
UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}
SPMV_ULPS, SPMV_L1_ULPS = 32.0, 4.0
# segment: kernel and plain both sum a float32 row in float64 and round once,
# so a float32 row may differ by 1 ulp where the float64 sums, added in
# other orders, fall on two sides of a rounding boundary; a float64 row is
# held to SEGMENT_F64_RTOL of its sum of |x|.  Integer rows are exact.
SEGMENT_F64_RTOL = 1e-12

N_NODES, N_EDGES, SEED, ITERS = 875_000, 5_100_000, 7, 20
# Batch TF-IDF at BASELINE config 2's size: the stand-in bench.py builds for
# 20-Newsgroups (19K docs, ~180 tokens each, Zipf(1.3) over 50K words, seed
# 7), hashed into 2^18 terms.  IDF and weights are held to TFIDF_RTOL of a
# float64 numpy oracle: float32 rounds each of the few operations behind a
# weight to within 6e-8, and the per-document sums run in float64.
TFIDF_DOCS, TFIDF_TOKENS, TFIDF_SEED, TFIDF_BITS = 19_000, 180, 7, 18
TFIDF_RTOL, TFIDF_REPS, QUERY_K = 2e-6, 5, 10
# Kernels of the composite SpMV around cumsum (int32 index widening, the leading-zero
# cat, the index gathers) that the fused spmv kernel removes from the loop.
WIDENING_KERNELS = ("direct_copy_kernel", "CatArrayBatchedCopy", "index_elementwise_kernel")
MAIN_IMPLS = ("segment", "pallas", "hybrid")
# The segment kernel's second kernel and the spmv difference kernel, gone
# since each call became one kernel; and the device ops per step of the loops
# before, which those loops now stay below.  The spmv descriptors' memset went
# too: a loop's own sums set one memset a step and one for the last delta, and
# the memset of each spmv call came on top of those.
RETIRED_OPS = ("segment_fixup", "row_diff")
ONE_OP_LIMITS = {"segment": 11.3, "pallas": 12.3}

# What the JAX package's probes print (tools/gather_micro.py:174-178,
# tools/spmv_breakdown.py:114-180, tools/xla_cost_micro.py:106-149), beside
# the port's stamp.  tests/test_torch_tools.py holds the port's tools to the
# JAX tools' own output on the CPU.
STAMP_KEYS = {"backend", "device", "power_limit"}
PROBE_KEYS = {
    "gather_micro": {"reps", "modes", "best_mode", "widest_lane_ok"},
    "xla_cost_micro": {"E", "N", "reps", "ops"},
    "spmv_breakdown": {"n_nodes", "n_edges", "reps", "ms_per_op", "dominant_component",
                       "dominant_component_segment_path"},
}
GATHER_MODES = {f"lane_w{w}" for w in (128, 256, 512, 1024, 2048, 4096, 8192, 32768, 109184)
                } | {"sublane_w1024", "bcast_w109184"}
GATHER_MODE_KEYS = {"compile_ok", "ms_per_rep", "gathers", "ns_per_gather"}
XLA_OPS = {"row_gather_T128", "gather_small_1k", "gather_med_64k", "xla_take_along_lanes",
           "scatter_add_N_into_E", "segment_sum_E_to_1k", "sort_E_pairs", "transpose_R128"}
BREAKDOWN_STAGES = {
    "gather_w_src", "gather_w_src_sorted", "cumsum_E", "cumsum_blocked_E",
    "segment_sum_E_to_N", "monotone_diff_N", "spmv_cumsum", "spmv_cumsum_mxu",
    "spmv_segment", "hybrid_head_rowsum", "spmv_hybrid", "spmv_sort_shuffle",
    "full_step_cumsum"}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def check_segment(sk, values, ptr, n: int, label: str, *, src=None, ew=None,
                  exact: bool = False, plan=None) -> tuple[float, float]:
    """``segment_sum_kernel`` against ``segment_sum_plain`` on one input: two
    calls through ``ptr``'s plan (built here unless given) and two without
    one, all four bit for bit.  With ``exact`` (integer inputs whose sums are exact)
    kernel, plain and the float64 sum must be equal; else float32 rows must
    lie within 1 ulp of plain (both sum in float64 and round once) and
    float64 rows within SEGMENT_F64_RTOL of the row's sum of |x|.  Returns
    the max abs difference and the largest ratio to the row's limit."""
    plan = sk.segment_plan(ptr) if plan is None else plan
    got = sk.segment_sum_kernel(values, ptr, n, src=src, edge_weight=ew, plan=plan)
    again = sk.segment_sum_kernel(values, ptr, n, src=src, edge_weight=ew, plan=plan)
    bare = [sk.segment_sum_kernel(values, ptr, n, src=src, edge_weight=ew) for _ in range(2)]
    want = sk.segment_sum_plain(values, ptr, n, src=src, edge_weight=ew)
    torch.cuda.synchronize()
    check(got.shape == (n,) and got.dtype == values.dtype, f"segment {label}: shape/dtype")
    check(bool(torch.isfinite(got).all()), f"segment {label}: not finite")
    check(torch.equal(got, again), f"segment {label}: two calls differ")
    check(all(torch.equal(got, b) for b in bare), f"segment {label}: calls without a plan differ")
    if n == 0:
        return 0.0, 0.0
    if exact:
        f64 = sk.segment_sum_plain(values.double(), ptr, n, src=src,
                                   edge_weight=None if ew is None else ew.double())
        check(torch.equal(got, want) and torch.equal(got.double(), f64),
              f"segment {label}: integer sums differ from plain or from float64")
        return 0.0, 0.0
    diff = (got.double() - want.double()).abs()
    if values.dtype == torch.float32:
        inf = torch.full_like(want, float("inf"))
        ulp = (torch.nextafter(want.abs(), inf) - want.abs()).double()
        limit = ulp
    else:
        per = values if src is None else values[src]
        if ew is not None:
            per = per * ew
        limit = SEGMENT_F64_RTOL * sk.segment_sum_plain(per.abs(), ptr, n)
    worst = float((diff / limit.clamp_min(torch.finfo(torch.float64).tiny)).max())
    check(bool((diff <= limit).all()),
          f"segment {label}: a row differs from plain by {worst:.3g} of its limit "
          f"({'1 ulp' if values.dtype == torch.float32 else f'{SEGMENT_F64_RTOL} of sum |x|'})")
    return float(diff.max()), worst


def segment_cases(rng, block: int) -> dict:
    """Edge-case CSR layouts ``{name: ptr}`` (numpy, n = len - 1) for the
    segment kernel: no rows, no values, sizes around one and several blocks
    of ``block`` merge-path items, a hub row spanning many blocks amid runs
    of empty rows, a long run of empty rows, rows each ending on a block
    boundary, and trailing empty rows."""
    def from_dst(n, dst):
        return np.searchsorted(np.sort(dst), np.arange(n + 1))

    cases = {"n=0": np.zeros(1, np.int64), "E=0, n=1000": np.zeros(1001, np.int64)}
    for n, e in ((1, 1), (1, block - 1), (1, block), (1, block + 1), (1000, 31),
                 (1000, block - 1), (1000, 5 * block + 7), (3 * block + 1, block)):
        cases[f"n={n} E={e}"] = from_dst(n, rng.integers(0, n, e))
    hub = 150 * block
    cases[f"one hub row of {hub}"] = np.array([0, hub])
    cases[f"hub row 57 of 100 ({hub} values)"] = np.r_[np.zeros(58), np.full(43, hub)]
    cases["50,000 rows, values in the last 10"] = from_dst(50_000, rng.integers(49_990, 50_000,
                                                                               5000))
    # row r holds block - 1 values, so each row's end is the last item of a block
    cases["every row ends a block"] = np.arange(41) * (block - 1)
    cases["trailing 20,000 empty rows"] = from_dst(30_000, rng.integers(0, 10_000, 3 * block))
    return cases


def sweep_segment(sk, graphs: dict, rng) -> dict:
    """:func:`check_segment` on each ``{name: ptr}``: the value loader and
    the gather loader (over a table of 1000, or of n where given as
    ``(ptr, src)``), unweighted and weighted, in float32 and float64, on
    real values and on small integers.  Returns the largest ratio to the
    row limit per dtype."""
    most = {torch.float32: 0.0, torch.float64: 0.0}
    for name, case in graphs.items():
        ptr_np, src_np = case if isinstance(case, tuple) else (case, None)
        n, e = len(ptr_np) - 1, int(ptr_np[-1])
        if src_np is None:
            src_np = rng.integers(0, 1000, e)
        table = int(src_np.max()) + 1 if e else 1
        ptr = torch.from_numpy(np.asarray(ptr_np, np.int32)).to("cuda")
        src = torch.from_numpy(np.asarray(src_np, np.int32)).to("cuda")
        plan = sk.segment_plan(ptr)
        inputs = {"real": (rng.random(e), rng.random(table), rng.uniform(0.5, 2.0, e)),
                  "integer": (rng.integers(-3, 4, e).astype(np.float64),
                              rng.integers(1, 4, table).astype(np.float64),
                              rng.integers(1, 3, e).astype(np.float64))}
        for kind, (x64, w64, ew64) in inputs.items():
            for dtype in (torch.float32, torch.float64):
                x, w, ew = (torch.from_numpy(a).to("cuda", dtype) for a in (x64, w64, ew64))
                exact = kind == "integer"
                for loader, kw in (("values", dict(values=x)),
                                   ("gather", dict(values=w, src=src)),
                                   ("gather weighted", dict(values=w, src=src, ew=ew))):
                    label = f"{name} {loader} {kind} {dtype}"
                    _, worst = check_segment(sk, ptr=ptr, n=n, label=label, exact=exact,
                                             plan=plan, **kw)
                    most[dtype] = max(most[dtype], worst)
        print(f"segment {name} (n={n}, E={e}): values and gather loaders, unweighted and "
              f"weighted, float32 within 1 ulp and float64 within {SEGMENT_F64_RTOL} of "
              f"sum |x| of plain; integers equal to plain and float64; two calls with the "
              f"plan and two without equal")
    return most


def measure_segment(sk, src, ptr, w, label: str) -> dict:
    """The segment kernel's gather loader at the main path's shapes (the
    ``segment`` impl's SpMV, through its graph's plan), against its plain
    version (float64 ``index_add_``), one library call
    (``torch.segment_reduce`` over the same pointers, on the gathered
    values) and its byte bound: src, ptr, w read once and the output
    written once.  The call without a plan is timed beside it."""
    n, e = w.shape[0], src.shape[0]
    plan = sk.segment_plan(ptr)
    check(plan.state.numel() == _build.library("segment").segment_scratch_len(n, e),
          "segment plan scratch differs from segment_scratch_len")
    err, worst = check_segment(sk, w, ptr, n, label, src=src, plan=plan)
    per_edge = w[src]  # gathered before timing
    got = sk.segment_sum_kernel(w, ptr, n, src=src, plan=plan)
    exact = sk.segment_sum_plain(w.double(), ptr, n, src=src)
    rel = float(((got.double() - exact).abs() / exact.abs().clamp_min(1e-300)).max())
    b, by = bound_ms(src.nbytes + ptr.nbytes + w.nbytes + got.nbytes, e, torch.float64)
    bare = time_ms(lambda: sk.segment_sum_kernel(w, ptr, n, src=src))
    row = {"ms": time_ms(lambda: sk.segment_sum_kernel(w, ptr, n, src=src, plan=plan)),
           "plain_ms": time_ms(lambda: sk.segment_sum_plain(w, ptr, n, src=src)),
           "library_ms": time_ms(lambda: torch.segment_reduce(per_edge, "sum", offsets=ptr,
                                                              unsafe=True)),
           "bound_ms": b, "bound_by": by, "max_abs_err": err}
    print(f"segment {label}: kernel {row['ms']:.4f} ms (without a plan {bare:.4f}), plain "
          f"(float64 index_add_) "
          f"{row['plain_ms']:.4f} ms, library (torch.segment_reduce) {row['library_ms']:.4f} ms, "
          f"bound {b:.4f} ms ({by}); vs plain max abs diff {err:.3g} ({worst:.3g} of 1 ulp), "
          f"largest relative error vs float64 {rel:.3g}")
    return row


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (float -0.0 and 0.0 told apart)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        bits = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


def check_put(pt, pk, sk, graph, label: str) -> dict:
    """``csrc/put.cu``'s wrappers on the card from what the card's put
    copies of ``graph`` (``src``, the int64 pointers narrowed as the put
    narrows them, the out-degree; a float64 out-strength beside it), each
    bit for bit equal to its plain version on the same inputs and to the
    numpy builder the CPU put runs.  Returns the inputs, for timing."""
    n, e = graph.n_nodes, graph.n_edges
    ip = graph.csr_indptr()
    ptr = torch.from_numpy(ip).to("cuda").to(torch.int32)
    deg = torch.from_numpy(graph.out_degree).to("cuda")
    rng = np.random.default_rng(SEED)
    strength = torch.from_numpy(graph.out_degree * (rng.random(n) * 3 + 0.5)).to("cuda")
    tiles = sk.segment_tiles(n, e)
    rows = pt.spmv_rows_kernel(ptr, e, pk.TILE)
    got = {
        "spmv_rows": (rows, pt.spmv_rows_plain(ptr, e, pk.TILE),
                      pk.spmv_rows(ip).astype(np.int32)),
        "expand_dst": (pt.expand_dst_kernel(ptr, e, rows, pk.TILE), pt.expand_dst_plain(ptr, e),
                       graph.dst),
        "segment_coords": (pt.segment_coords_kernel(ptr, e, tiles, sk.BLOCK_ITEMS),
                           pt.segment_coords_plain(ptr, e, tiles, sk.BLOCK_ITEMS),
                           sk.segment_coords(ip).astype(np.int32)),
    }
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        host = graph.inv_out_strength(name)
        for norm_label, norm in (("out-degree", deg), ("float64 out-strength", strength)):
            kern = pt.node_vectors_kernel(norm, dtype)
            plain = pt.node_vectors_plain(norm, dtype)
            for part, k, q in zip(("inv_outdeg", "dangling", "has_outlinks"), kern, plain):
                check(same_bits(k, q), f"put {label}: node_vectors {norm_label} {name} "
                                       f"{part} differs from plain")
            if norm is deg:
                got[f"node_vectors {name}"] = (kern[0], plain[0], host)
    for what, (kern, plain, host) in got.items():
        check(same_bits(kern, plain), f"put {label}: {what} differs from its plain version")
        check(same_bits(kern, torch.from_numpy(np.ascontiguousarray(host)).to("cuda")),
              f"put {label}: {what} differs from the numpy builder")
    print(f"put {label} (n={n}, E={e}): spmv_rows, expand_dst, segment_coords and "
          f"node_vectors (out-degree and float64 out-strength, float32 and float64) equal "
          f"their plain versions and the numpy builders bit for bit")
    return {"ptr": ptr, "deg": deg, "rows": rows, "tiles": tiles}


def measure_put(pt, pk, sk, graph, inputs: dict) -> dict:
    """``csrc/put.cu``'s kernels at the main path's graph, one row each:
    the kernel against its plain version, one library call where one
    computes the same thing (given what that call needs, built before
    timing) and its byte bound.  A plan's bound is its output written
    once; ``expand_dst`` writes ``dst`` and reads the pointers and the
    plan once; ``node_vectors`` reads the out-degree and writes its three
    float32 / float64 vectors."""
    n, e = graph.n_nodes, graph.n_edges
    ptr, deg, rows, tiles = inputs["ptr"], inputs["deg"], inputs["rows"], inputs["tiles"]
    tiles_v = rows.shape[0] - 1
    starts = torch.arange(1, tiles_v, dtype=torch.int32, device="cuda") * pk.TILE
    keys = ptr[1:].to(torch.int64) + torch.arange(1, n + 1, dtype=torch.int64, device="cuda")
    d = torch.clamp(torch.arange(tiles + 1, dtype=torch.int64, device="cuda") * sk.BLOCK_ITEMS,
                    max=n + e)
    node_ids = torch.arange(n, dtype=torch.int32, device="cuda")
    counts = ptr.diff()
    work = {
        "spmv_rows": (lambda: pt.spmv_rows_kernel(ptr, e, pk.TILE),
                      lambda: pt.spmv_rows_plain(ptr, e, pk.TILE),
                      lambda: torch.searchsorted(ptr, starts, right=True, out_int32=True),
                      "torch.searchsorted", 4 * (tiles_v + 1)),
        "expand_dst": (lambda: pt.expand_dst_kernel(ptr, e, rows, pk.TILE),
                       lambda: pt.expand_dst_plain(ptr, e),
                       lambda: torch.repeat_interleave(node_ids, counts, output_size=e),
                       "torch.repeat_interleave", 4 * e + 4 * (n + 1) + 4 * (tiles_v + 1)),
        "segment_coords": (lambda: pt.segment_coords_kernel(ptr, e, tiles, sk.BLOCK_ITEMS),
                           lambda: pt.segment_coords_plain(ptr, e, tiles, sk.BLOCK_ITEMS),
                           lambda: torch.searchsorted(keys, d, right=True, out_int32=True),
                           "torch.searchsorted", 4 * (tiles + 1)),
        # no one library call gives the three vectors
        "node_vectors": (lambda: pt.node_vectors_kernel(deg, torch.float32),
                         lambda: pt.node_vectors_plain(deg, torch.float32), None, None, 20 * n),
    }
    check(same_bits(work["expand_dst"][2](), work["expand_dst"][0]())
          and same_bits(work["segment_coords"][2](), work["segment_coords"][0]())
          and same_bits(work["spmv_rows"][2](), rows[1:tiles_v]),
          "put: a library call differs from the kernel it is timed beside")
    out = {}
    for name, (kern, plain, library, library_name, nbytes) in work.items():
        b, by = bound_ms(nbytes)
        row = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(library) if library is not None else None,
               "bound_ms": b, "bound_by": by, "max_abs_err": 0.0}  # equal bit for bit
        lib = (f"library ({library_name}) {row['library_ms']:.4f} ms"
               if library is not None else "no library call gives it")
        print(f"put {name} main path (n={n}, E={e}): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, {lib}, bound {b:.4f} ms ({by}), equal")
        out[name] = row
    return out


def measure_widened(sk, values, ptr, n: int, label: str, *, src=None, ew=None) -> dict:
    """segment.cu's float32-in, float64-out entry (``out_dtype=
    torch.float64``, the ``owned`` head's partials) on one input: two calls
    through ``ptr``'s plan bit for bit equal, equal bit for bit to its plain
    version (the float64 ``index_add_`` of the float32 products, not
    rounded: these sums of uniform-rank values are exact in float64, so no
    order changes them), and its rows rounded to float32 equal to the
    float32 entry's, which rounds the same accumulator once.  Timed beside
    the float32 entry; its byte bound: the inputs read once and the
    float64 rows written once."""
    plan = sk.segment_plan(ptr)
    kw = dict(src=src, edge_weight=ew)
    got = sk.segment_sum_kernel(values, ptr, n, plan=plan, out_dtype=torch.float64, **kw)
    again = sk.segment_sum_kernel(values, ptr, n, plan=plan, out_dtype=torch.float64, **kw)
    want = sk.segment_sum_plain(values, ptr, n, out_dtype=torch.float64, **kw)
    narrow = sk.segment_sum_kernel(values, ptr, n, plan=plan, **kw)
    torch.cuda.synchronize()
    check(got.shape == (n,) and got.dtype == torch.float64, f"widened segment {label}: "
                                                            f"shape/dtype {got.dtype}")
    check(torch.equal(got, again), f"widened segment {label}: two calls differ")
    differ = int((got != want).sum())
    err = float((got - want).abs().max()) if n else 0.0
    check(differ == 0, f"widened segment {label}: {differ} of {n} rows differ in bits from "
                       f"plain (max abs diff {err:.3g})")
    check(torch.equal(got.float(), narrow), f"widened segment {label}: its rows rounded to "
                                            "float32 differ from the float32 entry's")
    inputs = sum(t.nbytes for t in (values, ptr, src, ew) if t is not None)
    b, by = bound_ms(inputs + got.nbytes, src.shape[0] if src is not None else values.shape[0],
                     torch.float64)
    row = {"ms": time_ms(lambda: sk.segment_sum_kernel(values, ptr, n, plan=plan,
                                                       out_dtype=torch.float64, **kw)),
           "f32_out_ms": time_ms(lambda: sk.segment_sum_kernel(values, ptr, n, plan=plan, **kw)),
           "plain_ms": time_ms(lambda: sk.segment_sum_plain(values, ptr, n,
                                                            out_dtype=torch.float64, **kw)),
           "bound_ms": b, "bound_by": by, "max_abs_err": err, "bits_differ": differ}
    print(f"segment widened (float32 in, float64 out) {label}: kernel {row['ms']:.4f} ms, the "
          f"float32-out entry {row['f32_out_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"bound {b:.5f} ms ({by}); {differ} rows differ in bits from plain, rows rounded to "
          "float32 equal to the float32 entry's, two calls equal")
    return row


def owned_head_inputs(graph, weighted: torch.Tensor, rng) -> tuple:
    """Slot 0's head partial call of ``owned`` over 16b's 4-slot partition
    of ``graph``, as ``owned_step`` makes it: its lookup vector's length
    (``[local slice | boundary table | head | 0]``), drawn from the main
    path's uniform-rank values, then the slot's ``hsrc``, ``hw`` and
    ``hptr`` on the card."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import pagerank_sharded as ps

    sg = ps.partition_graph(graph, SHARD_SLOTS, strategy="owned")
    sh = sg.owned
    a = ps.device_put_sharded_graph(sg, pmesh.make_mesh(SHARD_SLOTS,
                                                        devices=["cuda:0"] * SHARD_SLOTS))[0]
    size = sh.block + SHARD_SLOTS * sh.b_pad + sh.h_pad
    pick = torch.from_numpy(rng.integers(0, weighted.shape[0], size)).to("cuda")
    lookup = torch.cat([weighted[pick], weighted.new_zeros(1)])
    return lookup, a.hptr, sh.h_pad + 2, a.hsrc, a.hw


def measure_cumsum(pk, x: torch.Tensor, label: str) -> dict:
    got = pk.cumsum_kernel(x)
    again = pk.cumsum_kernel(x)
    want = pk.cumsum_plain(x)
    torch.cuda.synchronize()
    check(got.shape == x.shape and got.dtype == x.dtype, f"cumsum {label} shape/dtype")
    check(torch.equal(got, again), f"cumsum {label}: two calls differ")
    err_abs = float((got - want).abs().max()) if x.numel() else 0.0
    scale = torch.cumsum(x.abs(), 0).clamp_min(torch.finfo(x.dtype).tiny)
    err_rel = float(((got - want).abs() / scale).max()) if x.numel() else 0.0
    rtol = CUMSUM_RTOL[x.dtype]
    check(bool(torch.isfinite(got).all()) and err_rel <= rtol,
          f"cumsum {label}: error {err_rel:.3g} of the running sum of |x| > {rtol}")
    # integers in -3..3 at x's offset: every partial sum is exact in either
    # type, so the kernel must equal the plain version bit for bit
    gen = torch.Generator(device=x.device).manual_seed(x.numel())
    off = x.storage_offset()
    xi = torch.randint(-3, 4, (off + x.numel(),), generator=gen, device=x.device,
                       dtype=x.dtype)[off:]
    check(torch.equal(pk.cumsum_kernel(xi), pk.cumsum_plain(xi)),
          f"cumsum {label}: integer sums differ from plain")
    n, size = x.numel(), x.element_size()
    b, by = bound_ms(2 * n * size, n, x.dtype)
    row = {"ms": time_ms(lambda: pk.cumsum_kernel(x)),
           "plain_ms": time_ms(lambda: pk.cumsum_plain(x)),
           "library_ms": time_ms(lambda: torch.cumsum(x, 0)),
           "bound_ms": b, "bound_by": by, "max_abs_err": err_abs}
    print(f"cumsum {label}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {b:.4f} ms ({by}), "
          f"max_abs_err {err_abs:.3g}, rel {err_rel:.3g} (tol {rtol})")
    return row


def check_rowsum(pk, rows: torch.Tensor, label: str) -> tuple[float, float]:
    """``rowsum_kernel`` against ``rowsum_plain`` within ROWSUM_RTOL of each
    row's sum of |x|; two calls bit for bit.  Returns the max abs and
    relative errors."""
    got = pk.rowsum_kernel(rows)
    again = pk.rowsum_kernel(rows)
    want = pk.rowsum_plain(rows)
    torch.cuda.synchronize()
    check(got.shape == (rows.shape[0],) and got.dtype == rows.dtype, f"rowsum {label} shape")
    check(torch.equal(got, again), f"rowsum {label}: two calls differ")
    if rows.shape[0] == 0:
        return 0.0, 0.0
    err_abs = float((got - want).abs().max())
    scale = rows.abs().sum(dim=1).clamp_min(torch.finfo(rows.dtype).tiny)
    err_rel = float(((got - want).abs() / scale).max())
    rtol = ROWSUM_RTOL[rows.dtype]
    check(bool(torch.isfinite(got).all()) and err_rel <= rtol,
          f"rowsum {label}: error {err_rel:.3g} of the row sum of |x| > {rtol}")
    return err_abs, err_rel


def rowsum_plan(width: int, dtype) -> tuple[int, int]:
    """Rows one block of ``csrc/rowsum.cu`` covers with one task a warp, and
    the blocks of one wave, for an aligned ``[*, width]`` matrix."""
    block_rows, wave = ctypes.c_longlong(), ctypes.c_longlong()
    size = torch.empty(0, dtype=dtype).element_size()
    rc = _build.library("rowsum").rowsum_plan(width, size, ctypes.byref(block_rows),
                                              ctypes.byref(wave))
    check(rc == 0 and block_rows.value > 0 and wave.value > 0,
          f"rowsum_plan({width}, {dtype}) returned {rc}")
    return block_rows.value, wave.value


def sweep_rowsum(pk, rng) -> int:
    """``rowsum`` on widths around the 16-byte route's limits (below 4, not a
    multiple of 4, wider than a warp's 8 vectors a lane), at row counts
    around one block's run and one wave, and on unaligned bases, in float32
    and float64.  Returns the number of cases."""
    cases = 0
    for dtype in (torch.float32, torch.float64):
        for w in (1, 3, 8, 100, 128, 129, 1000):
            block_rows, wave = rowsum_plan(w, dtype)
            counts = sorted({max(r, 0) for r in (block_rows - 1, block_rows, block_rows + 1,
                                                  block_rows * wave - 1, block_rows * wave + 1)})
            for r in counts:
                rows = torch.from_numpy(rng.random((r, w))).to("cuda", dtype)
                check_rowsum(pk, rows, f"R={r} W={w} {dtype}")
                cases += 1
            print(f"rowsum sweep W={w} {dtype}: block of {block_rows} rows, wave of {wave} "
                  f"blocks; R in {counts} within tolerance, two calls equal")
        # unaligned bases: a row slice of an odd-width matrix, and a
        # multiple-of-4 width one element off 16-byte alignment
        for r, w in ((1025, 129), (1025, 128)):
            buf = torch.from_numpy(rng.random(r * w + w)).to("cuda", dtype)
            odd = buf[w:].view(r, w) if w % 2 else buf[1:r * w + 1].view(r, w)
            check(odd.data_ptr() % 16 != 0 or w % 4 != 0, "rowsum unaligned case is aligned")
            check_rowsum(pk, odd, f"unaligned R={r} W={w} {dtype}")
            cases += 1
    return cases


def rowsum_yardstick(pk, rng) -> None:
    """``rowsum`` on its 16-byte route beside its scalar loop, which takes
    a matrix of the same shape one element off 16-byte alignment: at a
    narrow, the main path's and a wide width, float32."""
    for r, w in ((70000, 16), (15112, 128), (8448, 1000)):
        buf = torch.from_numpy(rng.random(r * w + 1)).to("cuda", torch.float32)
        rows, off = buf[:r * w].view(r, w), buf[1:].view(r, w)
        check_rowsum(pk, off, f"scalar loop R={r} W={w}")
        vec, scalar = time_ms(lambda: pk.rowsum_kernel(rows)), time_ms(lambda: pk.rowsum_kernel(off))
        print(f"rowsum R={r} W={w}: 16-byte route {vec:.4f} ms, scalar loop {scalar:.4f} ms")


def measure_rowsum(pk, rows: torch.Tensor, label: str) -> dict:
    err_abs, err_rel = check_rowsum(pk, rows, label)
    rtol = ROWSUM_RTOL[rows.dtype]
    r, w = rows.shape
    size = rows.element_size()
    b, by = bound_ms(r * w * size + r * size, r * (w - 1), rows.dtype)
    ones = torch.ones(w, dtype=rows.dtype, device=rows.device)
    row = {"ms": time_ms(lambda: pk.rowsum_kernel(rows)),
           "plain_ms": time_ms(lambda: pk.rowsum_plain(rows)),
           "library_ms": time_ms(lambda: torch.mv(rows, ones)),
           "bound_ms": b, "bound_by": by, "max_abs_err": err_abs}
    print(f"rowsum {label}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {b:.4f} ms ({by}), "
          f"max_abs_err {err_abs:.3g}, rel {err_rel:.3g} (tol {rtol})")
    return row


def gather_staged(gk, mode, x: torch.Tensor, idx: torch.Tensor) -> bool:
    """Whether the wrapper takes the staged route for these inputs (its
    output is fresh, so 16-byte aligned)."""
    aligned = x.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0
    return gk.stages_table(x.shape[0], idx.shape[1], mode.axis, aligned=aligned,
                           table_limit=gk.table_limit(x.device))


def route_name(x_rows: int, axis: int, staged: bool) -> str:
    """What the gather's route stages, for the report."""
    if not staged:
        return "L2 loop"
    if x_rows == 1:
        return "the broadcast row"
    return f"all {x_rows} rows" if axis == 0 else "one row"


def gather_l2(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``csrc/gather.cu``'s L2 loop on any inputs, the whole kernel before
    the staged route; a yardstick only, so it counts no launch."""
    out = torch.empty_like(idx, dtype=torch.float32)
    rc = _build.library("gather").gather_f32(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], idx.shape[0], idx.shape[1],
        axis, 0, torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"gather L2 loop launch failed: {rc}")
    return out


def check_gather(gk, mode, x: torch.Tensor, idx: torch.Tensor, label: str) -> torch.Tensor:
    """The gather kernel against its plain version on one mode's inputs: a
    gather is exact, so the two must be equal bit for bit."""
    got = gk.take_along_rows_kernel(x, idx, axis=mode.axis)
    want = gk.take_along_rows_plain(x, idx, axis=mode.axis)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"gather {label}: kernel differs from plain")
    return got


def sweep_gather_routes(gk, gather_micro, rng) -> None:
    """Every mode on both sides of each width limit of the staged route
    (where the L2 loop's table outgrows L1; where all 8 rows, and where one
    row, outgrow a block), at 1 and 3 blocks of 8 rows, bit for bit against
    plain; each mode must have run both routes."""
    limit = gk.table_limit(torch.device("cuda"))
    l1 = gk.L1_TABLE_BYTES // 4
    limits = {"L1, 8 rows": l1 // 8, "L1, one row": l1, "all 8 rows": limit // 32 // 4 * 4,
              "one row": limit // 4 // 4 * 4}
    seen = {"lane": set(), "sublane": set(), "bcast": set()}
    for name, widest in limits.items():
        for w in (widest, widest + 4):
            for kind in seen:
                for steps in (1, 3):
                    mode = gather_micro.Mode(w, steps, 0 if kind == "sublane" else 1,
                                             kind == "bcast")
                    x, idx = (torch.from_numpy(a).to("cuda")
                              for a in gather_micro.mode_inputs(mode, rng))
                    seen[kind].add(gather_staged(gk, mode, x, idx))
                    check_gather(gk, mode, x, idx, f"{kind} W={w} steps={steps}")
        print(f"gather at the {name} limit (W = {widest}, {widest + 4}): lane, sublane and "
              f"broadcast, steps 1 and 3, equal to plain")
    check(all(routes == {False, True} for routes in seen.values()),
          f"gather route sweep: staged route taken per mode {seen}")
    print(f"gather route sweep ran both routes in every mode; table limit {limit} bytes a block")


def measure_gather(gk, mode, x: torch.Tensor, idx: torch.Tensor, label: str,
                   yardstick: bool = False) -> dict:
    """:func:`check_gather`, then kernel, plain and library times; with
    ``yardstick``, the L2 loop's time too, on the same inputs."""
    got = check_gather(gk, mode, x, idx, label)
    staged = gather_staged(gk, mode, x, idx)
    steps, w = idx.shape[0] // gk.BLOCK_ROWS, idx.shape[1]
    table = x.expand(gk.BLOCK_ROWS, w).unsqueeze(0).expand(steps, gk.BLOCK_ROWS, w)
    idx64 = idx.view(steps, gk.BLOCK_ROWS, w).long()  # widened before timing
    dim = 2 if mode.axis == 1 else 1
    b, by = bound_ms(idx.nbytes + got.nbytes + x.nbytes)
    row = {"ms": time_ms(lambda: gk.take_along_rows_kernel(x, idx, axis=mode.axis)),
           "plain_ms": time_ms(lambda: gk.take_along_rows_plain(x, idx, axis=mode.axis)),
           "library_ms": time_ms(lambda: torch.gather(table, dim, idx64)),
           "bound_ms": b, "bound_by": by, "max_abs_err": 0.0}  # equal bit for bit
    note = ""
    if yardstick:
        check(torch.equal(gather_l2(x, idx, mode.axis), got), f"gather {label}: L2 loop differs")
        l2 = time_ms(lambda: gather_l2(x, idx, mode.axis))
        ns = 1e6 / idx.numel()
        note = (f"; ns per gather {row['ms'] * ns:.5f}, L2 loop {l2:.4f} ms "
                f"({l2 * ns:.5f} ns per gather)")
    print(f"gather {label} [{route_name(x.shape[0], mode.axis, staged)}]: kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms, bound {b:.4f} ms ({by}), equal{note}")
    return row


def spmv_error(got, want, src, indptr, w, ew, label: str) -> tuple[float, float, float]:
    """``got`` against ``want`` within SPMV_ULPS units of each row's scale
    and SPMV_L1_ULPS over all rows.  Returns the max abs difference and the
    largest and the L1 ratio to ``u`` times the scale."""
    per_edge = w.double()[src]
    if ew is not None:
        per_edge = per_edge * ew.double()
    c = torch.cat([per_edge.new_zeros(1), torch.cumsum(per_edge.abs(), 0)])
    scale = UNIT_ROUNDOFF[w.dtype] * (c[indptr[1:]] + c[indptr[:-1]])
    diff = (got.double() - want.double()).abs()
    worst = float((diff / scale.clamp_min(torch.finfo(torch.float64).tiny)).max())
    l1 = float(diff.sum() / scale.sum().clamp_min(torch.finfo(torch.float64).tiny))
    check(bool((diff <= SPMV_ULPS * scale).all()),
          f"spmv {label}: a row differs by {worst:.3g} u of its scale > {SPMV_ULPS}")
    check(l1 <= SPMV_L1_ULPS, f"spmv {label}: L1 difference {l1:.3g} u of the scales "
                              f"> {SPMV_L1_ULPS}")
    return float(diff.max()), worst, l1


def check_spmv(pk, src, indptr, w, ew, label: str, exact: bool,
               plan=None) -> tuple[float, float, float]:
    """The fused ``spmv`` kernel against ``spmv_pallas_plain`` on one input:
    two calls through ``indptr``'s plan (built here unless given) and two
    without one, all four bit for bit.  With ``exact`` (integer inputs whose sum is
    exact in ``w``'s type) kernel, plain and the float64 sum must be equal;
    else :func:`spmv_error` holds kernel to plain."""
    n = w.shape[0]
    plan = pk.spmv_plan(indptr) if plan is None else plan
    got = pk.spmv_pallas(src, indptr, w, n=n, edge_weight=ew, plan=plan)
    again = pk.spmv_pallas(src, indptr, w, n=n, edge_weight=ew, plan=plan)
    bare = [pk.spmv_pallas(src, indptr, w, n=n, edge_weight=ew) for _ in range(2)]
    want = pk.spmv_pallas_plain(src, indptr, w, n=n, edge_weight=ew)
    torch.cuda.synchronize()
    check(got.shape == (n,) and got.dtype == w.dtype, f"spmv {label}: shape/dtype")
    check(bool(torch.isfinite(got).all()), f"spmv {label}: not finite")
    check(torch.equal(got, again), f"spmv {label}: two calls differ")
    check(all(torch.equal(got, b) for b in bare), f"spmv {label}: calls without a plan differ")
    if not exact:
        return spmv_error(got, want, src, indptr, w, ew, label)
    exact_sum = pk.spmv_pallas_plain(src, indptr, w.double(), n=n,
                                     edge_weight=None if ew is None else ew.double())
    check(torch.equal(got, want) and torch.equal(got.double(), exact_sum),
          f"spmv {label}: integer sums differ from plain or from float64")
    return 0.0, 0.0, 0.0


def spmv_cases(rng, tile: int) -> dict:
    """Edge-case CSR graphs ``{name: (src, indptr)}`` as numpy arrays: E
    around the scan's tile, empty leading and trailing rows, one hub row
    holding every edge across more than 32 tiles."""
    def csr(n, e, lead=0, tail=0):
        dst = np.sort(rng.integers(lead, n - tail, e))
        return rng.integers(0, n, e), np.searchsorted(dst, np.arange(n + 1))

    cases = {f"E={e}": csr(1000, e) for e in (1, 31, tile - 1, tile, tile + 1, 5 * tile + 7)}
    cases["empty rows 0-9 and last 10"] = csr(1000, 3 * tile + 5, lead=10, tail=10)
    e_hub = 40 * tile
    cases[f"hub row of {e_hub} edges"] = (rng.integers(0, 100, e_hub),
                                         np.r_[np.zeros(58), np.full(43, e_hub)])
    return cases


def sweep_spmv(pk, graphs: dict, rng) -> dict:
    """:func:`check_spmv` on each ``{name: (src, indptr, w)}`` in float32 and
    float64, unweighted and weighted, on real values (``w`` None means
    uniform random) and on integers (``w`` in 1..3, edge weights 1 or 2).
    Returns the largest row and L1 ratios (units of ``u``) per type."""
    most = {dtype: [0.0, 0.0] for dtype in UNIT_ROUNDOFF}
    for name, (src_np, indptr_np, w_np) in graphs.items():
        src = torch.from_numpy(np.asarray(src_np, np.int32)).to("cuda")
        indptr = torch.from_numpy(np.asarray(indptr_np, np.int32)).to("cuda")
        n, e = indptr.shape[0] - 1, src.shape[0]
        values = {"real": (rng.random(n) if w_np is None else w_np, rng.uniform(0.5, 2.0, e)),
                  "integer": (rng.integers(1, 4, n).astype(np.float64),
                              rng.integers(1, 3, e).astype(np.float64))}
        w_int, ew_int = values["integer"]
        check(float((w_int[np.asarray(src_np)] * ew_int).sum()) < 2.0 ** 24,
              f"spmv {name}: integer sum not exact in float32")
        plan = pk.spmv_plan(indptr)
        parts = []
        for kind, (w64, ew64) in values.items():
            for dtype in (torch.float32, torch.float64):
                w = torch.from_numpy(w64).to("cuda", dtype)
                for ew in (None, torch.from_numpy(ew64).to("cuda", dtype)):
                    label = f"{name} {kind} {dtype} {'un' if ew is None else ''}weighted"
                    err, worst, l1 = check_spmv(pk, src, indptr, w, ew, label, kind == "integer",
                                                plan)
                    most[dtype] = [max(most[dtype][0], worst), max(most[dtype][1], l1)]
                    if kind == "real":
                        parts.append(f"{str(dtype)[6:]} {'un' if ew is None else ''}weighted "
                                     f"{err:.3g} ({worst:.3g} u, L1 {l1:.3g} u)")
        print(f"spmv {name} (N={n}, E={e}): max abs diff from plain (largest row / L1 in "
              f"units u of the scale): " + "; ".join(parts)
              + "; integers equal to plain and float64; two calls with the plan and two "
              "without equal")
    return most


def measure_spmv_pallas(pk, ops, src, indptr, w) -> dict:
    """The fused ``spmv`` kernel at the main path's shapes, against its
    plain version (``torch.cumsum``), the composite around the
    ``cumsum`` kernel, the one library call that computes the same function
    (a CSR sparse matrix-vector product) and its byte bound: src, w, indptr
    read once and the output written once."""
    n, e = w.shape[0], src.shape[0]
    plan = pk.spmv_plan(indptr)
    check(plan.state.numel() == _build.library("spmv").spmv_scratch_len(e),
          "spmv plan scratch differs from spmv_scratch_len")
    got = pk.spmv_pallas(src, indptr, w, n=n, plan=plan)
    plain = pk.spmv_pallas_plain(src, indptr, w, n=n)
    mat = torch.sparse_csr_tensor(indptr, src, torch.ones(e, dtype=w.dtype, device=w.device),
                                  size=(n, n), check_invariants=False)
    want = ops.cumsum_diff_spmv(w.double()[src], indptr)
    err, worst, l1 = spmv_error(got, want, src, indptr, w, None, "main path vs float64")
    b, by = bound_ms(src.nbytes + w.nbytes + indptr.nbytes + got.nbytes)
    bare = time_ms(lambda: pk.spmv_pallas(src, indptr, w, n=n))
    row = {"ms": time_ms(lambda: pk.spmv_pallas(src, indptr, w, n=n, plan=plan)),
           "plain_ms": time_ms(lambda: pk.spmv_pallas_plain(src, indptr, w, n=n)),
           "library_ms": time_ms(lambda: mat @ w),
           "bound_ms": b, "bound_by": by, "max_abs_err": float((got - plain).abs().max())}
    composite = time_ms(lambda: ops.cumsum_diff_spmv(w[src], indptr, pk.cumsum_kernel))
    print(f"spmv E={e} N={n}: kernel {row['ms']:.4f} ms (without a plan {bare:.4f}), plain "
          f"{row['plain_ms']:.4f} ms, "
          f"composite around cumsum {composite:.4f} ms, library (sparse CSR @ w) "
          f"{row['library_ms']:.4f} ms, bound {b:.4f} ms ({by}), max abs err vs float64 "
          f"{err:.3g} (largest row {worst:.3g} u, L1 {l1:.3g} u), vs plain "
          f"{row['max_abs_err']:.3g}")
    return row


# The profiler places each kernel by the card's clock converted to the
# host's, and keeps only the kernels it places inside its window.  On the
# H100 that conversion can place a kernel milliseconds before its own
# launch, and a trace of a few short calls then now and then holds no
# kernel at all.  So the host waits PROFILE_PAD_S before the work of a
# profiled step and after its last sync: no kernel lies near an edge.
PROFILE_PAD_S = 0.05


def profile_calls(fn, calls: int = 1) -> list:
    """Device and host events of ``calls`` calls of ``fn()`` under
    ``torch.profiler``: ``[(name, ms, count, "cuda" | "cpu")]``, device
    events first, each kind by time.  Only self times count: a host op's
    device total repeats its kernels', and so does the profiler's own
    ``ProfilerStep`` range.  The first profiled step is a warm-up the
    profiler discards, and a call of a few kernels is repeated: a trace
    misses its first kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(2):
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
    check(len(traces) == 1, f"profiler delivered {len(traces)} traces, wanted 1")
    rows = []
    for ev in traces[0]:
        if ev.key.startswith("ProfilerStep"):
            continue
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.key, ev.self_device_time_total / 1e3, ev.count, "cuda"))
        elif ev.device_type == DeviceType.CPU:
            rows.append((ev.key, ev.self_cpu_time_total / 1e3, ev.count, "cpu"))
    rows.sort(key=lambda r: (r[3] != "cuda", -r[1]))
    return rows


def profile_loop(runner, dg, ranks0, e) -> tuple[float, list]:
    """Device time (ms) of one run of the iteration loop, and its kernels
    and copies by device time."""
    rows = [r[:3] for r in profile_calls(lambda: float(runner(dg, ranks0, e)[2]))
            if r[3] == "cuda"]
    return sum(r[1] for r in rows), rows


def check_probe(tool: str, rec: dict) -> None:
    """A probe's record from the card: stamped ``gpu`` with the card's
    name and power limit, the JAX tool's keys, finite positive times, and
    no gather faster than its byte bound allows."""
    check(rec.get("backend") == "gpu" and rec.get("device") and rec.get("power_limit"),
          f"{tool}: stamp {({k: rec.get(k) for k in STAMP_KEYS})}")
    check(set(rec) - STAMP_KEYS == PROBE_KEYS[tool],
          f"{tool}: keys {sorted(set(rec) - STAMP_KEYS)}")
    if tool == "gather_micro":
        check(set(rec["modes"]) == GATHER_MODES, f"gather_micro: modes {sorted(rec['modes'])}")
        times = {}
        for name, m in rec["modes"].items():
            check(set(m) == GATHER_MODE_KEYS and m["compile_ok"], f"gather_micro {name}: {m}")
            w = int(name.split("_w")[1])
            table = (1 if name.startswith("bcast") else 8) * w * 4
            least, _ = bound_ms(8 * m["gathers"] + table)
            check(m["ms_per_rep"] * BOUND_SLACK >= least,
                  f"gather_micro {name}: {m['ms_per_rep']} ms is below its bound {least} ms")
            times[name] = m["ms_per_rep"]
        check(rec["best_mode"] in GATHER_MODES and rec["widest_lane_ok"] == 109184,
              f"gather_micro: best {rec['best_mode']}, widest {rec['widest_lane_ok']}")
    elif tool == "xla_cost_micro":
        check(set(rec["ops"]) == XLA_OPS, f"xla_cost_micro: ops {sorted(rec['ops'])}")
        times = {k: v["ms"] for k, v in rec["ops"].items()}
        check(all(set(v) == {"ms", "ns_per_elem"} for v in rec["ops"].values()),
              "xla_cost_micro: per-op keys")
    else:
        check(set(rec["ms_per_op"]) == BREAKDOWN_STAGES,
              f"spmv_breakdown: stages {sorted(rec['ms_per_op'])}")
        times = rec["ms_per_op"]
        check(rec["dominant_component"] in BREAKDOWN_STAGES
              and rec["dominant_component_segment_path"] in BREAKDOWN_STAGES,
              "spmv_breakdown: dominant stages")
    bad = {k: v for k, v in times.items() if not (isinstance(v, float) and 0 < v < float("inf"))}
    check(not bad, f"{tool}: times not finite and positive: {bad}")


def check_cli_trace(trace_dir: str, profile_dir: str) -> None:
    """The PageRank CLI's ``--trace-dir`` trace reads back through the
    repository's stdlib reader ``tools/trace_report.py`` with the JAX
    package's span names, and its ``--profile-dir`` Chrome trace holds the
    same span beside the card's kernels."""
    import glob
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_report", os.path.join(ROOT, "tools", "trace_report.py"))
    trace_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace_report)
    traces = glob.glob(os.path.join(trace_dir, "pagerank.*.trace.jsonl"))
    check(len(traces) == 1, f"CLI trace dir holds {traces}")
    rep = trace_report.report(traces[0])
    man = rep["manifest"]
    check("pagerank.call" in rep["breakdown"] and "pagerank.result_pull" in rep["spans"]
          and man["status"] == "ok" and man["backend"] == "cuda",
          f"CLI trace: top-level {sorted(rep['breakdown'])}, spans {sorted(rep['spans'])}, "
          f"manifest {man}")
    profiles = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    check(len(profiles) == 1, f"CLI profile dir holds {profiles}")
    with open(profiles[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check("pagerank.result_pull" in names and kernels > 0,
          f"CLI profile: result_pull span {'pagerank.result_pull' in names}, {kernels} kernels")
    print(f"cli trace: {rep['events']} events, phases "
          + ", ".join(f"{k} {v:.4f} s" for k, v in rep["breakdown"].items())
          + f"; profile {os.path.getsize(profiles[0])} bytes, {kernels} kernel events")


def dense_pagerank(graph, iterations: int, damping: float = 0.85) -> np.ndarray:
    """f64 power iteration on a dense matrix: the reference for the small
    graph (dangling=redistribute, init=uniform, uniform restart)."""
    n = graph.n_nodes
    a = np.zeros((n, n))
    np.add.at(a, (graph.dst, graph.src), 1.0 / graph.out_degree[graph.src])
    dangling = graph.out_degree == 0
    r = np.full(n, 1.0 / n)
    for _ in range(iterations):
        r = (1.0 - damping) / n + damping * (a @ r + r[dangling].sum() / n)
    return r


def extended_pagerank(graph, iterations: int, damping: float = 0.85) -> np.ndarray:
    """:func:`dense_pagerank` on the edge list in the host's long double
    (80-bit on x86), each node's in-links summed by ``np.add.reduceat``: a
    yardstick for float64 runs that add in other orders (phase 14a)."""
    n, ld = graph.n_nodes, np.longdouble
    order = np.argsort(graph.dst, kind="stable")
    src, dst = graph.src[order], graph.dst[order]
    inv = np.zeros(n, ld)
    out = graph.out_degree > 0
    inv[out] = ld(1) / graph.out_degree[out].astype(ld)
    has = np.bincount(dst, minlength=n) > 0
    starts = np.searchsorted(dst, np.flatnonzero(has))
    dangling = ~out
    r = np.full(n, ld(1) / n)
    for _ in range(iterations):
        inflow = np.zeros(n, ld)
        inflow[has] = np.add.reduceat((r * inv)[src], starts)
        r = (ld(1) - ld(damping)) / n + ld(damping) * (inflow + r[dangling].sum() / n)
    return r


def run_twice_bits(graph) -> dict:
    """Phase 4d: every SpMV impl's runner, and ``spark_exact`` over
    ``segment``, run twice on one device graph at full width in float32 and
    float64, the two rank vectors compared bit for bit.  Prints, per mode
    and dtype, whether they are equal and how many entries differ.  Returns
    ``{(mode, dtype): entries that differ}``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import put_graph_for
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        SPMV_IMPLS,
        PageRankConfig,
    )

    n = graph.n_nodes
    cases = []  # (mode, dtype, shape ok, [finite, entries that differ, max abs diff])
    for dtype in ("float32", "float64"):
        bits = torch.int32 if dtype == "float32" else torch.int64
        for impl in SPMV_IMPLS:
            cfg = PageRankConfig(iterations=ITERS, dangling="redistribute", init="uniform",
                                 dtype=dtype, spmv_impl=impl)
            dg = put_graph_for(graph, cfg, "cuda")  # once per impl and dtype
            modes = {impl: cfg}
            if impl == "segment":  # spark_exact needs dangling=drop, init=one
                modes["spark_exact"] = PageRankConfig(iterations=ITERS, dtype=dtype,
                                                      spmv_impl=impl, spark_exact=True)
            for mode, c in modes.items():
                make = ops.make_spark_exact_runner if c.spark_exact else ops.make_pagerank_runner
                runner = make(n, c)
                e = torch.from_numpy(ops.restart_vector(n, c)).to("cuda")
                r0 = torch.from_numpy(ops.init_ranks(n, c)).to("cuda")
                a, b = (runner(dg, r0, e)[0] for _ in range(2))
                # the comparison stays on the card; one pull reads every case
                cases.append((mode, dtype, a.shape == (n,), torch.stack([
                    torch.isfinite(a).all().double(),
                    (a.view(bits) != b.view(bits)).sum().double(),
                    (a - b).abs().max().double()])))
            del dg
    stats = torch.stack([v for *_, v in cases]).cpu().tolist()
    differ = {}
    for (mode, dtype, shaped, _), (finite, count, max_diff) in zip(cases, stats):
        check(shaped and finite == 1.0,
              f"determinism {mode} {dtype}: ranks not finite or wrong shape")
        differ[(mode, dtype)] = count = int(count)
        print(f"determinism {mode} {dtype}: two runs "
              f"{'equal bit for bit' if count == 0 else 'DIFFER'}; {count} of {n} "
              f"entries differ, max abs diff {max_diff:.3g}")
    return differ


def tfidf_oracle(corpus) -> dict:
    """The float64 numpy oracle's counts: one ``np.unique`` of the int64
    key ``term * 2^31 + doc`` with its counts (the COO in (term, doc)
    order), and ``np.bincount`` of the terms for DF."""
    key, count = np.unique(corpus.term_ids.astype(np.int64) * (1 << 31) + corpus.doc_ids,
                           return_counts=True)
    term = (key >> 31).astype(np.int32)
    return {"doc": (key % (1 << 31)).astype(np.int32), "term": term,
            "count": count.astype(np.float64),
            "df": np.bincount(term, minlength=1 << corpus.vocab_bits).astype(np.float64),
            "n": float(max(corpus.n_docs, 1)), "doc_lengths": corpus.doc_lengths}


def tfidf_oracle_weights(base: dict, tf_mode: str, idf_mode: str, l2: bool):
    """float64 ``(idf, weight)`` by the formulas of the JAX package's
    ``ops/tfidf.py:127-191``, on the oracle's counts."""
    n, df, count, doc = base["n"], base["df"], base["count"], base["doc"]
    with np.errstate(divide="ignore"):
        idf = {"classic": np.log(n / np.maximum(df, 1.0)),
               "mllib": np.log((n + 1.0) / (df + 1.0)),
               "smooth": np.log((1.0 + n) / (1.0 + df)) + 1.0}[idf_mode]
    idf = np.where(df > 0, idf, 0.0)
    tf = {"raw": count, "freq": count / np.maximum(base["doc_lengths"][doc], 1),
          "lognorm": 1.0 + np.log(count)}[tf_mode]
    w = tf * idf[base["term"]]
    if l2:
        sq = np.bincount(doc, weights=w * w, minlength=int(n))
        w = w / np.sqrt(np.maximum(sq, 1e-30))[doc]
    return idf, w


def rel_err(got, want) -> float:
    """Largest ``|got - want| / |want|``; a zero ``want`` counts as exact
    only where ``got`` is zero too."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    if not diff.size:
        return 0.0
    return float(np.max(np.where(want != 0, diff / np.where(want != 0, np.abs(want), 1.0),
                                 np.where(diff > 0, np.inf, 0.0))))


def check_tfidf_modes(tops, tcfg, corpus, base, device) -> dict:
    """``ops.tfidf_pipeline`` in every TF x IDF x L2 mode (18 runs) against
    the float64 oracle: COO, counts and DF equal, IDF and weights within
    TFIDF_RTOL; each L2 mode run twice, equal bit for bit.  Returns the
    default mode's result."""
    doc_t, term_t, len_t = (torch.from_numpy(a).to(device) for a in
                            (corpus.doc_ids, corpus.term_ids, corpus.doc_lengths))
    kw = dict(n_docs=max(corpus.n_docs, 1), vocab=1 << corpus.vocab_bits)
    results, notes = {}, {}
    for tf_mode in tcfg.TfMode:
        for idf_mode in tcfg.IdfMode:
            for l2 in (False, True):
                mode = dict(tf_mode=tf_mode, idf_mode=idf_mode, l2_normalize=l2)
                res = tops.tfidf_pipeline(doc_t, term_t, len_t, **kw, **mode)
                key = (tf_mode.value, idf_mode.value, l2)
                notes[key] = ""
                if l2:
                    again = tops.tfidf_pipeline(doc_t, term_t, len_t, **kw, **mode)
                    check(all(torch.equal(getattr(res, f), getattr(again, f))
                              for f in ("doc", "term", "weight", "idf", "df", "count")),
                          f"tfidf {tf_mode.value}/{idf_mode.value}/l2: two runs differ")
                    notes[key] = "; two runs equal bit for bit"
                results[key] = res
    # every mode is queued before the first pull
    fields = ("doc", "term", "count", "df", "idf", "weight")
    host = {key: {f: getattr(res, f).cpu().numpy() for f in fields}
            for key, res in results.items()}
    for (tf_mode, idf_mode, l2), h in host.items():
        label = f"{tf_mode}/{idf_mode}/{'l2' if l2 else 'no-l2'}"
        for f in ("doc", "term", "count", "df"):
            check(np.array_equal(h[f], base[f]), f"tfidf {label}: {f} differs from the oracle")
        idf, w = tfidf_oracle_weights(base, tf_mode, idf_mode, l2)
        e_idf, e_w = rel_err(h["idf"], idf), rel_err(h["weight"], w)
        check(e_idf <= TFIDF_RTOL and e_w <= TFIDF_RTOL,
              f"tfidf {label}: idf {e_idf:.3g}, weight {e_w:.3g} > rtol {TFIDF_RTOL}")
        print(f"tfidf {label}: COO, counts, df equal to the float64 oracle; largest "
              f"relative error idf {e_idf:.3g}, weight {e_w:.3g} (rtol {TFIDF_RTOL})"
              f"{notes[(tf_mode, idf_mode, l2)]}")
    return results


def check_tfidf_queries(tops, tio, base, results, bits: int, device) -> None:
    """``score_query`` top-10 against the oracle's stable order (score
    descending, lower doc id first), on the default and the smooth/L2
    results, for a head word, a rare one, a mid-frequency one and a
    two-word query."""
    n = int(base["n"])
    for tf_mode, idf_mode, l2 in (("raw", "classic", False), ("raw", "smooth", True)):
        _, w = tfidf_oracle_weights(base, tf_mode, idf_mode, l2)
        res = results[(tf_mode, idf_mode, l2)]
        for words in (["w1"], ["w0"], ["w250"], ["w7", "w1000"]):
            q = np.zeros(1 << bits, np.float32)
            q[tio.hash_to_vocab(tio.fnv1a_64(words), bits)] = 1.0
            want = np.bincount(base["doc"], weights=w * q[base["term"]], minlength=n)
            order = np.lexsort((np.arange(n), -want))[:QUERY_K]
            scores, idx = tops.score_query(res, torch.from_numpy(q).to(device), n_docs=n,
                                           k=QUERY_K)
            label = f"query {words} on {tf_mode}/{idf_mode}/{'l2' if l2 else 'no-l2'}"
            check(np.array_equal(idx.cpu().numpy(), order),
                  f"{label}: top-{QUERY_K} {idx.tolist()} != oracle {order.tolist()}")
            err = rel_err(scores.cpu().numpy(), want[order])
            check(err <= TFIDF_RTOL, f"{label}: score error {err:.3g} > {TFIDF_RTOL}")
            print(f"{label}: top-{QUERY_K} ids equal to the oracle's stable order "
                  f"{order.tolist()}, scores {np.round(want[order], 4).tolist()}, largest "
                  f"relative error {err:.3g}")


def check_tfidf_cli(tapi, tops, tio, device) -> None:
    """``python -m ...cli.tfidf`` on the tiny fixture: its output file and its
    printed top-k equal ``api.tfidf``'s, and ``score_query``'s, on the same
    inputs."""
    tiny = os.path.join(ROOT, "tests", "fixtures", "tiny.txt")
    query = ["node", "graph"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "weights.tsv")
        cmd = [sys.executable, "-m", "page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.tfidf",
               tiny, "--lines", "--vocab-bits", "10", "--idf-mode", "smooth", "--l2-normalize",
               "--query", *query, "--output", out, "--tuned-profile", "off"]
        if device.type == "cpu":
            cmd += ["--device", "cpu"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"tfidf CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            cli_file = f.read()
    docs, names = tio.load_corpus_lines(tiny)
    api = tapi.tfidf(docs, vocab_bits=10, idf_mode="smooth", l2_normalize=True, device=device)
    want_file = "".join(f"{names[d]}\t{t}\t{w:.10g}\n"
                        for d, t, w in zip(api.doc, api.term, api.weight))
    check(cli_file == want_file, "tfidf CLI output file differs from api.tfidf's")
    q = np.zeros(1 << 10, np.float32)
    q[tio.hash_to_vocab(tio.fnv1a_64(query), 10)] = 1.0
    res = tops.TfidfResult(*(torch.from_numpy(a).to(device) for a in
                             (api.doc, api.term, api.weight, api.idf, api.df)))
    scores, idx = tops.score_query(res, torch.from_numpy(q).to(device), n_docs=api.n_docs,
                                   k=min(10, api.n_docs))
    want_top = [f"{names[i]}\t{s:.10g}" for s, i in zip(scores.tolist(), idx.tolist()) if s > 0]
    check(proc.stdout.splitlines() == want_top,
          f"tfidf CLI top-k {proc.stdout.splitlines()} != api's {want_top}")
    summary = [ln for ln in proc.stderr.splitlines() if ln.startswith('{"docs"')]
    check(summary == [json.dumps({"docs": api.n_docs, "nnz": api.nnz})],
          f"tfidf CLI summary {summary}")
    print(f"tfidf cli: {len(cli_file.splitlines())} lines equal to api.tfidf's; top-k "
          f"{want_top} equal; {summary[0]}")


def check_graph_loaders(tg, native, graph) -> None:
    """The PageRank loaders with the native layer and with it forced off:
    ``load_snap`` of the tiny fixture, and the main path's graph rebuilt
    from its seed, equal array for array."""
    from unittest import mock

    def same(a, b) -> bool:
        return a.n_nodes == b.n_nodes and all(
            np.array_equal(getattr(a, f), getattr(b, f))
            for f in ("src", "dst", "out_degree", "node_ids"))

    tiny = os.path.join(ROOT, "tests", "fixtures", "tiny.txt")
    fast = tg.load_snap(tiny)
    with mock.patch.object(native, "parse_edge_file", return_value=None), \
            mock.patch.object(native, "sort_dedup_edges", return_value=None):
        slow = tg.load_snap(tiny)
        t0 = time.perf_counter()
        slow_main = tg.synthetic_powerlaw(N_NODES, N_EDGES, seed=SEED)
        slow_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast_main = tg.synthetic_powerlaw(N_NODES, N_EDGES, seed=SEED)
    fast_secs = time.perf_counter() - t0
    check(fast.native_steps == ("parse", "sort") and slow.native_steps == (),
          f"load_snap ran {fast.native_steps} natively, forced off {slow.native_steps}")
    check(same(fast, slow), "load_snap: native graph differs from the numpy path's")
    check(graph.native_steps == fast_main.native_steps == ("sort",)
          and slow_main.native_steps == (), "main path graph: native sort did not run")
    check(same(fast_main, slow_main) and same(fast_main, graph),
          "main path graph: native sort differs from the lexsort")
    print(f"graph loaders: tiny.txt parsed and sorted natively ({fast.n_nodes} nodes, "
          f"{fast.n_edges} edges), equal to the numpy path; main path graph "
          f"({graph.n_edges} edges) equal with the native sort ({fast_secs:.2f} s to build) "
          f"and the lexsort ({slow_secs:.2f} s)")


def tfidf_phase(device, reset_counts, counts, n_docs: int = TFIDF_DOCS,
                tokens: int = TFIDF_TOKENS, bits: int = TFIDF_BITS, reps: int = TFIDF_REPS,
                profile: bool = True) -> None:
    """Phase 8, batch TF-IDF at the config-2 stand-in's size (see the module
    docstring); every check raises on failure."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import api as tapi
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as tops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    # 8a. the corpus, tokenized by the C++ tokenizer
    t0 = time.perf_counter()
    docs = tio.synthetic_corpus_lines(n_docs, tokens, TFIDF_SEED)
    gen_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    corpus = tio.tokenize_corpus(docs, vocab_bits=bits)
    tok_secs = time.perf_counter() - t0
    check(corpus.native, "tfidf: the native tokenizer did not run")
    print(f"tfidf corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens "
          f"(built in {gen_secs:.2f} s); tokenize {tok_secs:.3f} s on the native path "
          f"({corpus.n_tokens / tok_secs:.4g} tokens/s)")

    # 8b. the default configuration through api.tfidf: one cold run, then
    # `reps` warm ones; no kernel of the port may launch on this path
    reset_counts()
    runs = [tapi.tfidf(docs, vocab_bits=bits, device=device) for _ in range(reps + 1)]
    launched = counts()
    check(not any(launched.values()), f"tfidf path launched kernels {launched}")
    ev = [{r["event"]: r for r in out.metrics.records if "event" in r} for out in runs]
    check(all(e["tokenize"]["native"] for e in ev), "tfidf: api.tfidf tokenized on numpy")
    cold, warm = ev[0]["pipeline"]["secs"], [e["pipeline"]["secs"] for e in ev[1:]]
    med = float(np.median(warm))
    tok = float(np.median([e["tokenize"]["secs"] for e in ev[1:]]))
    out = runs[-1]
    check(all(r.nnz == out.nnz and np.array_equal(r.weight, out.weight) for r in runs),
          "tfidf: api.tfidf runs differ")
    check(np.isfinite(out.weight).all() and np.isfinite(out.idf).all()
          and out.df.shape == out.idf.shape == (1 << bits,), "tfidf: output not finite/shaped")
    print(f"tfidf api (raw/classic/no-l2): nnz {out.nnz}; pipeline cold {cold:.4f} s, warm "
          f"median {med:.4f} s of {reps} (min {min(warm):.4f}, max {max(warm):.4f}); "
          f"{corpus.n_tokens / med:.4g} tokens/s through the pipeline, "
          f"{corpus.n_tokens / (med + tok):.4g} tokens/s with tokenize ({tok:.3f} s); "
          f"kernel launches {launched}")
    if profile:
        cfg = tcfg.TfidfConfig(vocab_bits=bits)
        calls = 3
        rows = [r for r in profile_calls(lambda: tm.pipeline(corpus, cfg, device), calls)
                if r[3] == "cuda"]
        device_ms = sum(r[1] for r in rows) / calls
        print(f"profile tfidf pipeline: device {device_ms:.3f} ms per call of a "
              f"{med * 1e3:.3f} ms warm pipeline (busy {device_ms / (med * 1e3):.3f}), "
              f"{sum(r[2] for r in rows) / calls:g} device ops per call; by op, ms per call: "
              + "; ".join(f"{k[:70]} {t / calls:.4f} x{c / calls:g}" for k, t, c, _ in rows))

    # 8c-8e. every mode against the float64 oracle, L2 twice, queries
    t0 = time.perf_counter()
    base = tfidf_oracle(corpus)
    results = check_tfidf_modes(tops, tcfg, corpus, base, device)
    check(np.array_equal(results[("raw", "classic", False)].weight.cpu().numpy(), out.weight),
          "tfidf: api.tfidf differs from ops.tfidf_pipeline in the default mode")
    check_tfidf_queries(tops, tio, base, results, bits, device)
    print(f"tfidf modes and queries checked in {time.perf_counter() - t0:.1f} s")

    # 8f. the CLI against the API
    check_tfidf_cli(tapi, tops, tio, device)


# Streaming TF-IDF (phase 9) at bench.py's streaming knobs (bench.py:271-285):
# documents in chunks of 512, re-packed to 2^18 tokens, padded to 2^18.  The
# config-5 stand-in is cut from ~6M Wikipedia documents to 100,000 (bigrams
# on) to fit the run's time.
STREAM_CHUNK_DOCS, STREAM_CHUNK_TOKENS = 512, 1 << 18
WIKI_DOCS, WIKI_TOKENS, WIKI_SEED = 100_000, 180, 11
KILL_AFTER, KILL_EVERY = 10, 4


class Killed(Exception):
    """The source of phase 9e's killed run."""


def chunked(docs, size: int) -> list:
    return [docs[i:i + size] for i in range(0, len(docs), size)]


def sorted_coo(out, device) -> dict:
    """A TfidfOutput's COO in (term, doc) order (the batch path's), sorted
    on ``device``; a dense matrix is too large at 2^18 columns."""
    doc, term = (torch.from_numpy(a).to(device) for a in (out.doc, out.term))
    order = torch.sort((term.long() << 31) | doc.long()).indices.cpu().numpy()
    return {"doc": out.doc[order], "term": out.term[order], "count": out.count[order],
            "weight": out.weight[order], "df": out.df, "idf": out.idf}


def check_same_coo(got, want, label: str) -> None:
    """Streaming against batch: the sorted COO, counts, weights, DF and IDF
    equal bit for bit."""
    a = sorted_coo(got, got.device)
    b = {f: getattr(want, f) for f in ("doc", "term", "count", "weight", "df", "idf")}
    check(got.n_docs == want.n_docs and got.nnz == want.nnz,
          f"{label}: {got.n_docs} docs, {got.nnz} pairs; batch {want.n_docs}, {want.nnz}")
    for f in ("doc", "term", "count", "weight", "df", "idf"):
        check(a[f].dtype == b[f].dtype and a[f].tobytes() == b[f].tobytes(),
              f"{label}: {f} differs from the batch path's")


def batch_rate(out) -> str:
    """A batch run's tokens/s with its tokenizer, from its records."""
    ev = {r["event"]: r for r in out.metrics.records if "event" in r}
    tok, dev = ev["tokenize"]["secs"], ev["pipeline"]["secs"]
    return (f"{ev['tokenize']['tokens']} tokens, tokenize {tok:.3f} s + pipeline {dev:.4f} s, "
            f"{ev['tokenize']['tokens'] / (tok + dev):.4g} tokens/s")


def stream_records(metrics) -> dict:
    recs = metrics.records
    return {"chunks": sum(r.get("event") == "chunk" for r in recs),
            "bumps": sum(r.get("event") == "chunk_cap_bump" for r in recs),
            "overlap": next(r for r in recs if r.get("event") == "ingest_overlap")}


def check_chunk_counts_carry(tops, corpus, device) -> None:
    """9a. ``chunk_counts_carry`` on ``device`` against the CPU on the same
    padded chunks (a real one at the run's capacity, one with no valid
    token, one whose every token is its own pair): outputs and carry are
    integers, so equal."""
    cap, vocab = STREAM_CHUNK_TOKENS, 1 << corpus.vocab_bits
    n = min(corpus.n_tokens, cap)
    real = (corpus.doc_ids[:n], corpus.term_ids[:n], n)
    ids = np.arange(cap, dtype=np.int32)
    cases = {"real chunk": real, "no valid token": real[:2] + (0,),
             "n_pairs == cap": (ids, ids % vocab, cap)}
    carries = {d: torch.zeros(vocab, dtype=torch.float32, device=d) for d in ("cpu", device)}
    runs = []  # (label, {device: (counts, the carry after the chunk)})
    for label, (doc, term, n_valid) in cases.items():
        outs = {}
        for d in carries:
            pad = [torch.zeros(cap, dtype=torch.int32) for _ in range(2)]
            pad[0][:len(doc)], pad[1][:len(term)] = torch.from_numpy(doc), torch.from_numpy(term)
            valid = torch.arange(cap) < n_valid
            counts, carries[d] = tops.chunk_counts_carry(pad[0].to(d), pad[1].to(d),
                                                         valid.to(d), carries[d], vocab=vocab)
            outs[d] = (list(counts), carries[d].clone())
        runs.append((label, outs))
    # every chunk is queued before the first pull
    pulled = [(label, {d: ([t.cpu() for t in c], k.cpu()) for d, (c, k) in outs.items()})
              for label, outs in runs]
    for label, outs in pulled:
        (c_cpu, k_cpu), (c_dev, k_dev) = outs["cpu"], outs[device]
        equal = all(torch.equal(a, b) for a, b in zip(c_cpu, c_dev))
        check(equal and torch.equal(k_cpu, k_dev),
              f"chunk_counts_carry {label}: {device} differs from the CPU")
        print(f"chunk_counts_carry {label}: n_pairs {int(c_cpu[3])} of {cap}; outputs "
              f"and carry on {device} equal to the CPU's")


def busy_us(events) -> float:
    """Microseconds the device was busy: the union of the Chrome-trace
    events' ``[ts, ts + dur)`` spans, overlaps merged."""
    busy, end = 0.0, -np.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_stream(run, cap: int, label: str, card_label: str) -> None:
    """9d. ``torch.profiler`` over one pipelined run: every chunk's H2D
    copy (``cap`` int32 doc and term ids) is ``Pinned -> Device`` and runs
    on a stream other than the one that sorts; the device's busy share of
    the run."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    with tempfile.TemporaryDirectory() as tmp:
        def ready(p):
            path = os.path.join(tmp, "trace.json")
            p.export_chrome_trace(path)
            with open(path) as f:
                traces.append(json.load(f))

        walls = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                time.sleep(PROFILE_PAD_S)
                t0 = time.perf_counter()
                out, m = run()
                walls.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)
                prof.step()
    check(len(traces) == 1, f"profiler delivered {len(traces)} traces, wanted 1")
    events = [e for e in traces[0]["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    h2d = [e for e in events if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    chunk_bytes = 2 * cap * 4
    chunk_copies = [e for e in h2d if e.get("args", {}).get("bytes") == chunk_bytes]
    sorts = [e for e in events if e["cat"] == "kernel" and "sort" in e["name"].lower()]
    n_chunks = stream_records(m)["chunks"]
    check(len(chunk_copies) == n_chunks,
          f"{label}: {len(chunk_copies)} chunk copies of {chunk_bytes} bytes, {n_chunks} chunks")
    kinds = sorted({e["name"] for e in chunk_copies})
    check(kinds == ["Memcpy HtoD (Pinned -> Device)"], f"{label}: chunk copies are {kinds}")
    copy_streams = {e["args"]["stream"] for e in chunk_copies}
    sort_streams = {e["args"]["stream"] for e in sorts}
    check(bool(sorts) and not copy_streams & sort_streams,
          f"{label}: chunk copies on streams {copy_streams}, sorts on {sort_streams}")
    busy = busy_us(events)
    other = sorted({e["name"] for e in h2d} - set(kinds))
    print(f"profile {label}: {len(chunk_copies)} chunk copies, all Pinned -> Device, on "
          f"streams {sorted(copy_streams)}; {len(sorts)} sort kernels on streams "
          f"{sorted(sort_streams)}; other H2D copies {other}; device busy "
          f"{busy / 1e3:.3f} ms of the {walls[1] * 1e3:.3f} ms run "
          f"({busy / 1e6 / walls[1]:.3f}) on {card_label}")


def streaming_phase(device, reset_counts, counts, card_label: str, *,
                    n_docs: int = TFIDF_DOCS, wiki_docs: int = WIKI_DOCS,
                    chunk_docs: int = STREAM_CHUNK_DOCS, bits: int = TFIDF_BITS,
                    profile: bool = True) -> dict:
    """Phase 9, streaming TF-IDF (see the module docstring); every check
    raises on failure.  Returns what phases 10 and 11 reuse."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ingest as dflow
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as tops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    knobs = dict(vocab_bits=bits, chunk_tokens=STREAM_CHUNK_TOKENS,
                 pack_target_tokens=STREAM_CHUNK_TOKENS)
    docs = tio.synthetic_corpus_lines(n_docs, TFIDF_TOKENS, TFIDF_SEED)
    corpus = tio.tokenize_corpus(docs, vocab_bits=bits)
    chunks = chunked(docs, chunk_docs)

    # 9a.
    check_chunk_counts_carry(tops, corpus, str(device))

    # the host's part alone, on this thread: packing, then tokenizing the
    # packed chunks
    t0 = time.perf_counter()
    packed = list(dflow.pack_doc_chunks(iter(chunks), knobs["pack_target_tokens"]))
    pack_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    for c in packed:
        tio.tokenize_corpus(c, vocab_bits=bits)
    tok_secs = time.perf_counter() - t0
    print(f"stream config-2 host only: pack {pack_secs:.3f} s into {len(packed)} chunks, "
          f"tokenize them {tok_secs:.3f} s, {corpus.n_tokens / (pack_secs + tok_secs):.4g} "
          f"tokens/s on {card_label}")

    # 9b. the config-2 stand-in, serial and pipelined, two modes, against
    # batch, after one untimed run (the caching allocators' first blocks)
    tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**knobs), device=device)
    reset_counts()
    for mode in ({}, {"idf_mode": "smooth", "l2_normalize": True}):
        batch = tm.run_tfidf(docs, tcfg.TfidfConfig(vocab_bits=bits, **mode), device=device)
        print(f"batch config-2 {mode or 'raw/classic'}: {batch_rate(batch)} on {card_label}")
        for prefetch, depth in ((0, 0), (2, 2)):
            m = MetricsRecorder()
            cfg = tcfg.TfidfConfig(**knobs, prefetch=prefetch, pipeline_depth=depth, **mode)
            t0 = time.perf_counter()
            out = tm.run_tfidf_streaming(iter(chunks), cfg, metrics=m, device=device)
            secs = time.perf_counter() - t0
            label = (f"stream config-2 {mode or 'raw/classic'} prefetch {prefetch} "
                     f"depth {depth}")
            check_same_coo(out, batch, label)
            rec = stream_records(m)
            print(f"{label}: {corpus.n_tokens} tokens in {secs:.3f} s, "
                  f"{corpus.n_tokens / secs:.4g} tokens/s on {card_label}; "
                  f"{rec['chunks']} chunks, {rec['bumps']} cap bumps, h2d_overlap_frac "
                  f"{rec['overlap']['h2d_overlap_frac']}, tokenize {rec['overlap']['tokenize_secs']}"
                  f" s, h2d {rec['overlap']['h2d_secs']} s, compute "
                  f"{rec['overlap']['compute_secs']} s; sorted COO, counts, weights, df and idf "
                  f"equal to batch bit for bit")
    launched = counts()
    check(not any(launched.values()), f"streaming path launched kernels {launched}")

    # 9c. the config-5 stand-in: bigrams, pipelined
    t0 = time.perf_counter()
    wiki = tio.synthetic_corpus_lines(wiki_docs, WIKI_TOKENS, WIKI_SEED)
    gen_secs = time.perf_counter() - t0
    wcfg = dict(knobs, ngram=2)
    batch = tm.run_tfidf(wiki, tcfg.TfidfConfig(vocab_bits=bits, ngram=2), device=device)
    n_tok = sum(r["tokens"] for r in batch.metrics.records if r.get("event") == "tokenize")
    print(f"batch config-5: {batch_rate(batch)} on {card_label}")
    m = MetricsRecorder()
    t0 = time.perf_counter()
    out = tm.run_tfidf_streaming(iter(chunked(wiki, chunk_docs)),
                                 tcfg.TfidfConfig(**wcfg), metrics=m, device=device)
    secs = time.perf_counter() - t0
    check_same_coo(out, batch, "stream config-5")
    rec = stream_records(m)
    print(f"stream config-5 (bigrams, {wiki_docs} docs built in {gen_secs:.1f} s): {n_tok} "
          f"tokens, {out.nnz} pairs in {secs:.3f} s, {n_tok / secs:.4g} tokens/s on "
          f"{card_label}; {rec['chunks']} chunks, {rec['bumps']} cap bumps, h2d_overlap_frac "
          f"{rec['overlap']['h2d_overlap_frac']}; equal to batch bit for bit")
    del batch, out

    # 9d. pinned copies on their own stream, shown by the profiler
    if profile:
        def run():
            m = MetricsRecorder()
            return tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**knobs), metrics=m,
                                          device=device), m

        profile_stream(run, STREAM_CHUNK_TOKENS, "stream config-2 pipelined", card_label)

    # 9e. kill after chunk KILL_AFTER, resume from the last checkpoint
    kcfg = dict(vocab_bits=bits, idf_mode="smooth", l2_normalize=True)
    whole = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**kcfg), device=device)

    def killed():
        yield from chunks[:KILL_AFTER]
        raise Killed(f"killed after chunk {KILL_AFTER}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg = tcfg.TfidfConfig(**kcfg, checkpoint_every=KILL_EVERY, checkpoint_dir=tmp)
        try:
            tm.run_tfidf_streaming(killed(), cfg, device=device)
            check(False, "the killed run did not raise")
        except Killed:
            pass
        start = tm.resume_point(cfg)
        resumed = tm.run_tfidf_streaming(iter(chunks), cfg, resume=True, device=device)
    check(0 < start < KILL_AFTER, f"kill and resume: resume point {start}")
    same = all(getattr(resumed, f).tobytes() == getattr(whole, f).tobytes()
               for f in ("doc", "term", "count", "weight", "df", "idf", "doc_lengths"))
    check(same, "kill and resume: the resumed run differs from an unbroken one")
    print(f"kill and resume: killed after chunk {KILL_AFTER} of {len(chunks)}, resumed at "
          f"checkpoint {start} (every {KILL_EVERY}); equal to an unbroken run bit for bit")
    return {"docs": docs, "wiki": wiki, "knobs": knobs, "chunk_docs": chunk_docs}


def index_phase(device, docs, knobs: dict, chunk_docs: int, card_label: str) -> None:
    """Phase 10: ``cli.tfidf --streaming --save-index`` on the config-2
    stand-in, read back by ``load_index`` and held to ``save_index`` of
    ``api.tfidf``'s output; BM25 against float64 numpy."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import api as tapi
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    bits = knobs["vocab_bits"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.txt")
        with open(path, "w") as f:
            f.writelines(d + "\n" for d in docs)
        cmd = [sys.executable, "-m", "page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.tfidf",
               path, "--lines", "--streaming", "--vocab-bits", str(bits),
               "--chunk-docs", str(chunk_docs), "--chunk-tokens", str(knobs["chunk_tokens"]),
               "--pack-target", str(knobs["pack_target_tokens"]),
               "--save-index", os.path.join(tmp, "cli"), "--tuned-profile", "off"]
        if device.type == "cpu":
            cmd += ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"tfidf CLI --save-index exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        got = serving.load_index(os.path.join(tmp, "cli"))
        cfg, bm = tcfg.TfidfConfig(vocab_bits=bits), tcfg.Bm25Config()
        out = tapi.tfidf(docs, cfg, device=device)
        serving.save_index(os.path.join(tmp, "api"), out, cfg, bm25=bm)
        want = serving.load_index(os.path.join(tmp, "api"))
        for f in ("doc", "term", "weight", "idf", "df", "term_offsets", "bm25_weight"):
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
            check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
                  f"index: {f} of the CLI's streaming build differs from save_index(api.tfidf)")
        check(got.cfg.config_hash() == cfg.config_hash() and got.n_docs == len(docs),
              "index: config or document count differs")
        # float64 BM25 on the same postings (api.tfidf's COO is in the
        # index's (term, doc) order)
        lengths = out.doc_lengths.astype(np.float64)
        n, k1, b = float(out.n_docs), bm.k1, bm.b
        dfp = got.df.astype(np.float64)[got.term]
        c = out.count.astype(np.float64)
        avgdl = max(lengths.sum() / n, 1.0)
        want_bm25 = (np.log1p((n - dfp + 0.5) / (dfp + 0.5)) * c * (k1 + 1.0)
                     / (c + k1 * (1.0 - b + b * lengths[got.doc] / avgdl)))
        err = rel_err(got.bm25_weight, want_bm25)
        check(err <= TFIDF_RTOL, f"index: bm25_weight {err:.3g} from float64 > {TFIDF_RTOL}")
    print(f"index: the CLI's streaming --save-index ({cli_secs:.1f} s with start-up on "
          f"{card_label}) loads with {got.nnz} postings, {got.n_docs} docs; doc, term, "
          f"weight, idf, df, term_offsets, bm25_weight equal to save_index(api.tfidf) bit "
          f"for bit; bm25_weight within {err:.3g} of float64 (rtol {TFIDF_RTOL})")


# Serving (phase 11) at the config-2 stand-in's full size and the config-5
# stand-in's segments.  SERVE_QUERIES queries from SERVE_SEED: 1-8 words
# drawn from the corpus's own tokens (so Zipf), about 1 in 20 with a word
# no document holds, 1 in 256 with more than 16 distinct words (the server
# keeps its 16 heaviest).  Cap 8 runs them all, every ranker, and the
# tfidf ones are held to the one-shot score_query; the smaller caps, the
# second run and the one-shot bm25 and prior checks take the first
# SERVE_CAP_QUERIES, and SERVE_CPU_QUERIES also run on the CPU.  Scores are
# held to SERVE_RTOL of a float64 oracle, and ids to its order wherever it
# sets a score apart by more than SERVE_RTOL.  Segments against a monolithic index:
# tfidf scores within SEGMENT_ATOL (the JAX package's bar, cosine-scale
# scores under smooth/L2), BM25 within SEGMENT_RTOL: the host re-weighting
# rounds its float32 formula in another order than the device's.
# 2,048 queries keep the whole script, phase 20 included, inside its time
# limit.
SERVE_QUERIES, SERVE_CAP_QUERIES, SERVE_CPU_QUERIES, SERVE_SEED = 2048, 512, 256, 13
SERVE_RTOL, PRIOR_ALPHA, SERVE_CAPS = 2e-6, 0.5, (8, 4, 2, 1)
PRIOR_NODES, PRIOR_EDGES = 19_000, 110_000
SEGMENTS, SEGMENT_QUERIES, SEGMENT_ATOL, SEGMENT_RTOL = 4, 512, 1e-5, 1e-5
CLI_QUERIES, PROFILE_BATCHES = 64, 50


def serving_queries(docs, n: int, seed: int) -> list:
    """``n`` queries of the corpus's own words (see SERVE_QUERIES)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        words = docs[int(rng.integers(len(docs)))].split()
        if i % 256 == 255:
            pick = list(dict.fromkeys(words))[:20]
        else:
            pick = [words[int(j)] for j in rng.integers(len(words), size=rng.integers(1, 9))]
        if i % 20 == 7:
            pick.append(f"zzabsent{i}")
        out.append(pick)
    return out


def serve_all(srv, queries, ranker: str) -> list:
    """Every query through ``srv.submit`` from one thread (the bounded
    queue holds the submitter back), then every result."""
    futs = [srv.submit(q, ranker=ranker) for q in queries]
    return [f.result(120.0) for f in futs]


def oracle_topk(index, table, canon, prior=None) -> list:
    """float64 scores of every document for each canonical query (scipy's
    sparse product over the stored weights), plus ``prior``."""
    import scipy.sparse as sp

    w = sp.csr_matrix((np.asarray(table, np.float64),
                       (np.asarray(index.doc), np.asarray(index.term))),
                      shape=(index.n_docs, index.vocab_size)).T.tocsr()
    out = []
    for a in range(0, len(canon), 256):
        part = canon[a:a + 256]
        rows = np.repeat(np.arange(len(part)), [len(t) for t, _ in part])
        cols = np.concatenate([t for t, _ in part]).astype(np.int64)
        vals = np.concatenate([q for _, q in part]).astype(np.float64)
        q = sp.csr_matrix((vals, (rows, cols)), shape=(len(part), index.vocab_size))
        dense = (q @ w).toarray()
        if prior is not None:
            dense += prior
        out.extend(dense)
    return out


def oracle_check(got_s, got_i, want, k: int) -> tuple[float, int, bool]:
    """(largest relative score error, positions whose id is held, ids equal
    there): ids are held wherever the oracle's group of equal scores is
    set apart from the next distinct scores by more than SERVE_RTOL."""
    kth = np.partition(-want, k - 1)[k - 1]
    cand = np.nonzero(-want <= kth)[0]
    order = cand[np.lexsort((cand, -want[cand]))]
    top = want[order]
    err = float(np.max(np.abs(got_s - top[:k]) / np.maximum(np.abs(top[:k]), 1e-30),
                       initial=0.0))
    err = 0.0 if np.array_equal(got_s, top[:k]) else err
    vals = np.unique(want)
    held = np.ones(k, bool)
    for j in range(k):
        i = np.searchsorted(vals, top[j])
        tol = SERVE_RTOL * max(abs(top[j]), 1e-30)
        held[j] = not ((i > 0 and top[j] - vals[i - 1] <= tol)
                       or (i + 1 < len(vals) and vals[i + 1] - top[j] <= tol))
    return err, int(held.sum()), bool(np.array_equal(got_i[held], order[:k][held]))


def doc_sums_probe(tops, device) -> str:
    """Whether ``ops.tfidf.doc_sums`` adds each document's rows left to right
    on ``device``: 64 documents of 4096 float64 rows each (magnitudes over
    12 decades, both signs), against numpy's sequential ``cumsum``."""
    rng = np.random.default_rng(5)
    n, rows = 64, 4096
    vals = rng.standard_normal(n * rows) * 10.0 ** rng.integers(-6, 6, n * rows)
    doc = np.repeat(np.arange(n, dtype=np.int32), rows)
    want = np.array([np.cumsum(vals[d * rows:(d + 1) * rows])[-1] for d in range(n)])
    got = tops.doc_sums(torch.from_numpy(vals).to(device), torch.from_numpy(doc).to(device),
                        n).cpu().numpy()
    differ = int((got != want).sum())
    return f"{differ} of {n} documents differ from a left-to-right float64 sum"


def one_shot(tops, res, qt, qw, n: int, k: int, vocab: int, device, prior=None):
    """The one-shot ``score_query`` on a dense query vector; with
    ``prior``, every document's score plus the float32 prior, re-sorted."""
    q = torch.zeros(vocab, dtype=torch.float32, device=device)
    q[torch.from_numpy(qt.astype(np.int64)).to(device)] = torch.from_numpy(qw).to(device)
    if prior is None:
        s, i = tops.score_query(res, q, n_docs=n, k=k)
        return s.cpu().numpy(), i.cpu().numpy()
    s, i = tops.score_query(res, q, n_docs=n, k=n)
    dense = torch.empty(n, dtype=torch.float32, device=device)
    dense[i.long()] = s
    top, idx = torch.sort(dense + prior, descending=True, stable=True)
    return top[:k].cpu().numpy(), idx[:k].int().cpu().numpy()


def build_serving_index(tmp, docs, device, reset_counts, counts, card_label: str):
    """11a's index: the config-2 stand-in through the batch path, saved
    with counts, BM25 and a PageRank prior from ``run_pagerank``
    (``segment``) over a 19,000-node power-law graph, scaled to mean 1."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import api as tapi
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    graph = synthetic_powerlaw(PRIOR_NODES, PRIOR_EDGES, seed=SEED)
    reset_counts()
    pr = run_pagerank(graph, tcfg.PageRankConfig(spmv_impl="segment"), device=device)
    launched = counts()
    ranks = np.full(len(docs), float(pr.ranks.mean()), np.float64)
    ranks[graph.node_ids[graph.node_ids < len(docs)]] = pr.ranks[graph.node_ids < len(docs)]
    ranks = (ranks / ranks.mean()).astype(np.float32)
    cfg = tcfg.TfidfConfig(vocab_bits=TFIDF_BITS)
    out = tapi.tfidf(docs, cfg, device=device)
    path = os.path.join(tmp, "index")
    serving.save_index(path, out, cfg, ranks=ranks, bm25=tcfg.Bm25Config(), counts=True)
    index = serving.load_index(path)
    print(f"serving index: {index.n_docs} docs, {index.nnz} postings, BM25, counts; prior "
          f"from run_pagerank (segment) over {graph.n_nodes} nodes, {graph.n_edges} edges, "
          f"{pr.iterations} iterations, launches {launched}, mean 1 on {card_label}")
    if device.type == "cuda":
        check(launched["segment"] >= pr.iterations,
              f"the prior's PageRank launched segment {launched['segment']} times")
    return index, launched


def check_scorers(tops, serving, index, queries, device, reset_counts, counts,
                  card_label: str) -> dict:
    """11a: every cap, both scorings, every ranker, on ``device``; impacted
    equal to COO, every cap equal to cap 8, two runs equal, served equal to
    the one-shot ``score_query``, the CPU's bits on the first queries, and
    the float64 oracle.  Returns the prior server's prior and the results."""
    n, k = index.n_docs, QUERY_K
    results = {}
    t0 = time.perf_counter()
    reset_counts()
    for scoring in ("coo", "impacted"):
        for cap in SERVE_CAPS:
            cfg = serving.ServeConfig(max_batch=cap, cache_size=0, prior_alpha=PRIOR_ALPHA,
                                      scoring=scoring)
            with serving.TfidfServer(index, cfg, device=device) as srv:
                qs = queries if cap == SERVE_CAPS[0] else queries[:SERVE_CAP_QUERIES]
                for ranker in serving.RANKERS:
                    results[(scoring, cap, ranker)] = serve_all(srv, qs, ranker)
                if scoring == "coo" and cap == SERVE_CAPS[0]:
                    results["again"] = serve_all(srv, qs[:SERVE_CAP_QUERIES], "tfidf")
                    canon = [srv.make_query(q) for q in queries]
                    prior = srv._segs[0].prior_req
                stats = srv.stats()
            print(f"serve {scoring} cap {cap}: {stats['batches']} batches for "
                  f"{stats['requests']} requests ({stats['dedup_hits']} in-batch duplicates)")
    launched = counts()
    secs = time.perf_counter() - t0
    check(not any(launched.values()), f"scoring launched kernels {launched}")

    def same(a, b) -> bool:
        return all(x[0].tobytes() == y[0].tobytes() and x[1].tobytes() == y[1].tobytes()
                   for x, y in zip(a, b))

    for ranker in serving.RANKERS:
        for cap in SERVE_CAPS:
            check(same(results[("impacted", cap, ranker)], results[("coo", cap, ranker)]),
                  f"{ranker} cap {cap}: impacted differs from coo")
            check(same(results[("coo", cap, ranker)], results[("coo", 8, ranker)]),
                  f"{ranker} cap {cap}: differs from cap 8")
    check(same(results["again"], results[("coo", 8, "tfidf")]), "two runs differ")
    truncated = sum(len(set(q)) > 16 for q in queries)
    print(f"serve: {len(queries)} queries ({truncated} past 16 distinct words), caps "
          f"{SERVE_CAPS} (caps under 8 on the first {SERVE_CAP_QUERIES}), tfidf/bm25/prior, "
          f"in {secs:.1f} s; impacted equal to coo, every cap to cap 8, two runs equal, bit "
          f"for bit; kernel launches while scoring {launched}")

    # served against the one-shot score_query, and the float64 oracle
    tables = {"tfidf": index.weight, "bm25": index.bm25_weight, "prior": index.weight}
    t0 = time.perf_counter()
    for ranker, table in tables.items():
        res = tops.TfidfResult(*(torch.from_numpy(np.array(a)).to(device) for a in
                                 (index.doc, index.term, table, index.idf, index.df)))
        served = results[("coo", 8, ranker)]
        p = prior if ranker == "prior" else None
        n_one = len(served) if ranker == "tfidf" else SERVE_CAP_QUERIES
        for (qt, qw), (s, i) in zip(canon[:n_one], served[:n_one]):
            es, ei = one_shot(tops, res, qt, qw, n, k, index.vocab_size, device, p)
            check(s.tobytes() == es.tobytes() and i.tobytes() == ei.tobytes(),
                  f"{ranker}: served differs from the one-shot score_query for {qt.tolist()}")
        want = oracle_topk(index, table, canon,
                           (PRIOR_ALPHA * np.asarray(index.ranks, np.float64))
                           if ranker == "prior" else None)
        errs, held, total = [], 0, 0
        for (s, i), w in zip(served, want):
            err, h, ok = oracle_check(s, i, w, k)
            check(ok, f"{ranker}: top-{k} ids differ from the float64 oracle's order")
            errs.append(err)
            held += h
            total += k
        worst = max(errs)
        check(worst <= SERVE_RTOL, f"{ranker}: score error {worst:.3g} > {SERVE_RTOL}")
        print(f"serve {ranker}: {n_one} results equal to the one-shot score_query bit "
              f"for bit; {len(served)} against float64: largest relative error {worst:.3g} (rtol "
              f"{SERVE_RTOL}), ids held at {held} of {total} positions, all equal")
    print(f"serve one-shot and oracle checks: {time.perf_counter() - t0:.1f} s")

    # the CPU's bits: the same port code, the same float64 adds in order
    t0 = time.perf_counter()
    cpu_q = queries[:SERVE_CPU_QUERIES]
    for scoring in ("impacted", "coo"):
        cfg = serving.ServeConfig(cache_size=0, prior_alpha=PRIOR_ALPHA, scoring=scoring)
        with serving.TfidfServer(index, cfg, device="cpu") as srv:
            for ranker in (serving.RANKERS if scoring == "impacted" else ("tfidf",)):
                qs = cpu_q if scoring == "impacted" else cpu_q[:64]
                got = serve_all(srv, qs, ranker)
                check(same(got, results[("coo", 8, ranker)]),
                      f"{ranker} on the CPU ({scoring}) differs from {device}")
    print(f"serve on the CPU: {SERVE_CPU_QUERIES} queries (impacted, every ranker) and 64 "
          f"(coo, tfidf) equal to {device} bit for bit, {time.perf_counter() - t0:.1f} s")
    print(f"doc_sums on {device}: {doc_sums_probe(tops, device)}; on cpu: "
          f"{doc_sums_probe(tops, torch.device('cpu'))} ({card_label})")
    return {"canon": canon, "prior": prior}


def closed_loop(srv, queries, clients: int, ranker: str = "tfidf") -> dict:
    """``clients`` threads, each submitting its share of ``queries`` one at
    a time and waiting for each answer; wall seconds and per-request
    latency and queue wait."""
    import threading

    lat, wait, errors = [], [], []
    lock = threading.Lock()

    def client(c: int) -> None:
        try:
            for q in queries[c::clients]:
                fut = srv.submit(q, ranker=ranker)
                fut.result(120.0)
                with lock:
                    lat.append(fut.latency_s)
                    wait.append(fut.t_queue_wait)
        except Exception as exc:  # noqa: BLE001 — reported by the caller
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,), name=f"smoke-client-{c}")
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    secs = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"closed-loop clients failed: {errors[:3]}")
    return {"secs": secs, "lat": sorted(lat), "wait": sorted(wait)}


def device_busy(fn) -> tuple[float, float, int]:
    """(device ms, wall ms, device ops) of one ``fn()`` under
    ``torch.profiler``: kernels, copies and memsets, overlaps merged."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return busy_us(events) / 1e3, wall * 1e3, len(events)


def bench_server(serving, metrics_pct, index, queries, canon, tops, device,
                 card_label: str) -> dict:
    """11b: ``ServeConfig()`` defaults but the cache, which holds every
    query so a second pass is all hits; four closed-loop clients, both
    scorings; per-cap dispatch device time; the device's busy share of
    PROFILE_BATCHES batches; a ``set_prior`` under traffic.  Returns the
    first pass's queries/s by scoring."""
    pct = metrics_pct
    n, k = index.n_docs, QUERY_K
    qps = {}
    for scoring in ("coo", "impacted"):
        cfg = serving.ServeConfig(scoring=scoring, cache_size=2 * len(queries))
        with serving.TfidfServer(index, cfg, device=device) as srv:
            r = closed_loop(srv, queries, 4)
            s1 = srv.stats()
            again = queries[:SERVE_CAP_QUERIES]
            r2 = closed_loop(srv, again, 4)
            s2 = srv.stats()
            check(s2["cache_hits"] - s1["cache_hits"] == len(again)
                  and s2["cache_misses"] == s1["cache_misses"],
                  f"{scoring}: the second pass was not all LRU hits ({s1} -> {s2})")
            times = {}
            if device.type == "cuda":
                with srv._lock:
                    segs = list(srv._segs)
                for cap in SERVE_CAPS:
                    uniq = [_pending(srv, q) for q in queries[:cap]]
                    plans = srv._pad(uniq, segs, cap)
                    times[cap] = time_ms(lambda: srv._dispatch(
                        "tfidf", plans, segs, [s.prior for s in segs], srv.k, cap))
                srv._cache.clear()
                busy, wall, ops = device_busy(lambda: closed_loop(
                    srv, queries[:PROFILE_BATCHES * 4], 4))
                s3 = srv.stats()
            lat, wait = r["lat"], r["wait"]
            qps[scoring] = len(queries) / r["secs"]
            print(f"server {scoring} (4 closed-loop clients, {len(queries)} queries): "
                  f"{len(queries) / r['secs']:.1f} queries/s, p50 {pct(lat, 0.5) * 1e3:.3f} ms,"
                  f" p99 {pct(lat, 0.99) * 1e3:.3f} ms, queue wait p50 "
                  f"{pct(wait, 0.5) * 1e3:.3f} ms; {s1['batches']} batches, "
                  f"{s1['cache_hits']} cache hits, {s1['dedup_hits']} in-batch duplicates; "
                  f"second pass of {len(again)} all LRU hits, {len(again) / r2['secs']:.1f} "
                  f"queries/s on {card_label}")
            if times:
                batches = s3["batches"] - s2["batches"]
                width = (f" (bucket cap {srv._bucket_cap} x {cfg.impact_bucket_width} lanes)"
                         if scoring == "impacted" else "")
                print(f"server {scoring} dispatch device ms by cap{width} (CUDA events, L2 "
                      "flushed): " + ", ".join(f"{c}: {t:.4f}" for c, t in times.items())
                      + f"; profiled {batches} batches: device busy {busy:.3f} ms of "
                      f"{wall:.3f} ms ({busy / wall:.3f}), {ops} device ops on {card_label}")

    # set_prior under traffic: results after it are the one-shot score plus
    # the new prior, bit for bit
    import threading

    new = np.random.default_rng(3).uniform(0.5, 1.5, n).astype(np.float32)
    cfg = serving.ServeConfig(scoring="impacted", prior_alpha=PRIOR_ALPHA)
    res = tops.TfidfResult(*(torch.from_numpy(np.array(a)).to(device) for a in
                             (index.doc, index.term, index.weight, index.idf, index.df)))
    with serving.TfidfServer(index, cfg, device=device) as srv:
        stop = threading.Event()
        errors = []

        def traffic():
            i = 0
            while not stop.is_set():
                try:
                    srv.query(queries[i % len(queries)], ranker="prior")
                except Exception as exc:  # noqa: BLE001 — reported below
                    errors.append(exc)
                i += 1

        threads = [threading.Thread(target=traffic, name=f"smoke-traffic-{k}")
                   for k in range(2)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.2)
            t0 = time.perf_counter()
            srv.set_prior(new)
            swap = time.perf_counter() - t0
            got = serve_all(srv, queries[:SERVE_CPU_QUERIES], "prior")
        finally:
            stop.set()
            for t in threads:
                t.join(60.0)
    check(not errors, f"set_prior under traffic: requests failed {errors[:3]}")
    prior = torch.from_numpy(np.zeros(n, np.float32) + PRIOR_ALPHA * new).to(device)
    for (qt, qw), (s, i) in zip(canon, got):
        es, ei = one_shot(tops, res, qt, qw, n, k, index.vocab_size, device, prior)
        check(s.tobytes() == es.tobytes() and i.tobytes() == ei.tobytes(),
              "set_prior: a result differs from the one-shot score plus the new prior")
    print(f"set_prior under traffic: swapped in {swap * 1e3:.2f} ms; {len(got)} results after "
          f"it equal to the one-shot score plus the new prior bit for bit")
    return qps


def _pending(srv, words):
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.server import _Pending

    qt, qw = srv.make_query(words)
    return _Pending(srv.query_key(qt, qw), qt, qw)


def segments_phase(serving, wiki, device, card_label: str, *, segments: int = SEGMENTS,
                   n_queries: int = SEGMENT_QUERIES) -> None:
    """11c: the config-5 stand-in (bigrams, smooth/L2) sealed as
    ``segments`` equal segments with ``commit_append``, served by both
    scorings against a monolithic index of the same corpus; then
    ``SegmentMerger.merge_once`` and ``refresh_segments`` under traffic,
    results unchanged bit for bit."""
    import threading

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    cfg = tcfg.TfidfConfig(vocab_bits=TFIDF_BITS, ngram=2, idf_mode="smooth",
                           l2_normalize=True)
    queries = serving_queries(wiki, n_queries, SERVE_SEED + 1)
    with tempfile.TemporaryDirectory() as tmp:
        seg_dir, mono_dir = os.path.join(tmp, "segments"), os.path.join(tmp, "mono")
        t0 = time.perf_counter()
        per = len(wiki) // segments
        base = 0
        for s in range(segments):
            part = wiki[s * per:(s + 1) * per if s < segments - 1 else len(wiki)]
            out = run_tfidf(part, cfg, device=device)
            ref = sgm.seal_segment(seg_dir, out, cfg, doc_base=base, bm25=tcfg.Bm25Config())
            sgm.commit_append(seg_dir, ref, cfg.config_hash())
            base += out.n_docs
        seal = time.perf_counter() - t0
        mono = run_tfidf(wiki, cfg, device=device)
        serving.save_index(mono_dir, mono, cfg, bm25=tcfg.Bm25Config())
        mono_index = serving.load_index(mono_dir)
        t0 = time.perf_counter()
        segset = sgm.load_segment_set(seg_dir)
        load = time.perf_counter() - t0
        check(segset.nnz == mono_index.nnz and segset.n_docs == mono_index.n_docs,
              f"segments hold {segset.nnz} postings, the monolithic index {mono_index.nnz}")
        print(f"segments: {len(segset.segments)} of ~{per} docs, {segset.nnz} postings, sealed "
              f"and committed in {seal:.1f} s, load_segment_set (global re-weighting) "
              f"{load:.2f} s on {card_label}")
        k = QUERY_K
        with serving.TfidfServer(mono_index, serving.ServeConfig(scoring="impacted",
                                                                 cache_size=0),
                                 device=device) as ref_srv:
            want = {r: serve_all(ref_srv, queries, r) for r in ("tfidf", "bm25")}
        for scoring in ("coo", "impacted"):
            t0 = time.perf_counter()
            srv = serving.TfidfServer(segset, serving.ServeConfig(scoring=scoring,
                                                                  cache_size=0),
                                      device=device).start()
            start = time.perf_counter() - t0
            try:
                held = 0
                for r, tol in (("tfidf", (SEGMENT_ATOL, 0.0)), ("bm25", (0.0, SEGMENT_RTOL))):
                    t0 = time.perf_counter()
                    got = serve_all(srv, queries, r)
                    qps = len(queries) / (time.perf_counter() - t0)
                    for (s, i), (ws, wi) in zip(got, want[r]):
                        check(np.allclose(s, ws, atol=tol[0], rtol=tol[1]),
                              f"segments {scoring} {r}: scores {s} vs monolithic {ws}")
                        gap = 2 * max(tol[0], tol[1] * float(np.abs(ws).max()))
                        for j in range(k - 1):
                            if ((j == 0 or ws[j - 1] - ws[j] > gap)
                                    and ws[j] - ws[j + 1] > gap):
                                held += 1
                                check(i[j] == wi[j], f"segments {scoring} {r}: id {i[j]} "
                                      f"at {j} vs monolithic {wi[j]}")
                    print(f"segments {scoring} {r}: {len(queries)} queries at {qps:.1f} "
                          f"queries/s (one submitter), scores within "
                          f"{'atol' if tol[0] else 'rtol'} {max(tol)} of the monolithic "
                          f"index's, ids equal where apart")
                if scoring == "impacted":
                    before = serve_all(srv, queries, "tfidf")
                    merger = sgm.SegmentMerger(seg_dir, cfg, max_segments=segments - 1)
                    stop = threading.Event()
                    errors = []

                    def traffic():
                        i = 0
                        while not stop.is_set():
                            try:
                                srv.query(queries[i % len(queries)])
                            except Exception as exc:  # noqa: BLE001 — reported below
                                errors.append(exc)
                            i += 1

                    threads = [threading.Thread(target=traffic, name=f"smoke-traffic-{k}")
                               for k in range(2)]
                    for t in threads:
                        t.start()
                    try:
                        t0 = time.perf_counter()
                        check(merger.merge_once(), "merge_once merged nothing")
                        merge = time.perf_counter() - t0
                        t0 = time.perf_counter()
                        merged = sgm.load_segment_set(seg_dir)
                        reload = time.perf_counter() - t0
                        t0 = time.perf_counter()
                        srv.refresh_segments(merged)
                        refresh = time.perf_counter() - t0
                    finally:
                        stop.set()
                        for t in threads:
                            t.join(60.0)
                    check(not errors, f"refresh under traffic: requests failed {errors[:3]}")
                    after = serve_all(srv, queries, "tfidf")
                    check(all(a[0].tobytes() == b[0].tobytes() and a[1].tobytes() ==
                              b[1].tobytes() for a, b in zip(after, before)),
                          "results changed across the merge")
                    print(f"segments merge: merge_once {merge:.2f} s into "
                          f"{len(merged.segments)} segments, reload {reload:.2f} s, "
                          f"refresh_segments (build and warm) {refresh:.2f} s under two "
                          f"clients, {srv.stats()['refreshes']} refresh; results unchanged "
                          f"bit for bit")
                cap = f", bucket cap {srv._bucket_cap}" if scoring == "impacted" else ""
                print(f"segments {scoring}: server start (put and warm) {start:.2f} s; ids "
                      f"held at {held} positions{cap}")
            finally:
                srv.stop()


def cli_phase(serving, index, queries, device, card_label: str) -> None:
    """11d: ``cli.serve`` on 11a's index from a query file (in this
    process) and from stdin (``python -m``, with ``GRAFT_METRICS_PORT=0``):
    its lines equal a server's results, its summary carries ``p50_ms`` and
    ``p99_ms``, and ``/snapshot.json`` shows the ``serve.latency_s``
    histogram while it runs."""
    import contextlib
    import io
    import urllib.request

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import serve as cli_serve

    qs = queries[:CLI_QUERIES]
    path = os.path.dirname(index.path)
    want = []
    with serving.TfidfServer(index, serving.ServeConfig(), device=device) as srv:
        for qid, q in enumerate(qs):
            s, d = srv.query(q)
            want += [f"{qid}\t{int(i)}\t{float(v):.10g}" for v, i in zip(s, d) if v > 0]
    dev = ["--tuned-profile", "off"] + ([] if device.type == "cuda" else ["--device", "cpu"])
    with tempfile.TemporaryDirectory() as tmp:
        qfile = os.path.join(tmp, "queries.txt")
        with open(qfile, "w") as f:
            f.writelines(" ".join(q) + "\n" for q in qs)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_serve.main([path, "--queries", qfile, *dev])
        secs = time.perf_counter() - t0
        check(rc == 0, f"cli.serve exited {rc}: {err.getvalue()[-2000:]}")
        check(out.getvalue().splitlines() == want, "cli.serve (file) lines differ from the "
              "server's results")
        summary = json.loads(err.getvalue().strip().splitlines()[-1])
        check(summary["requests"] == len(qs) and summary["p99_ms"] >= summary["p50_ms"] > 0,
              f"cli.serve summary {summary}")
        print(f"cli.serve (query file, {len(qs)} queries): {len(want)} lines equal to the "
              f"server's; summary p50_ms {summary['p50_ms']}, p99_ms {summary['p99_ms']}; "
              f"{secs:.1f} s in this process on {card_label}")

        errf = os.path.join(tmp, "stderr.txt")
        env = dict(os.environ, GRAFT_METRICS_PORT="0")
        t0 = time.perf_counter()
        with open(errf, "w") as ef:
            proc = subprocess.Popen(
                [sys.executable, "-m", "page_rank_and_tfidf_using_apache_spark_tpu_torch.cli.serve",
                 path, *dev], cwd=ROOT, env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=ef, text=True)
            try:
                proc.stdin.write("".join(" ".join(q) + "\n" for q in qs))
                proc.stdin.flush()
                url, snap, deadline = None, None, time.monotonic() + 300.0
                while time.monotonic() < deadline and proc.poll() is None:
                    time.sleep(0.2)
                    if url is None:
                        with open(errf) as f:
                            urls = [json.loads(ln)["metrics_url"] for ln in f
                                    if ln.startswith('{"metrics_url"')]
                        url = urls[0] if urls else None
                        continue
                    with urllib.request.urlopen(url + "/snapshot.json", timeout=10) as r:
                        snap = json.load(r)
                    if snap["latency_s"]["total"].get("count", 0) >= len(qs):
                        break
                proc.stdin.close()
                stdout = proc.stdout.read()
                rc = proc.wait(120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(30)
        secs = time.perf_counter() - t0
        with open(errf) as f:
            err_text = f.read()
        check(rc == 0, f"cli.serve (stdin) exited {rc}: {err_text[-2000:]}")
        check(snap is not None and snap["latency_s"]["total"].get("count") == len(qs),
              f"/snapshot.json serve.latency_s: {None if snap is None else snap['latency_s']}")
        check(stdout.splitlines() == want, "cli.serve (stdin) lines differ from the server's")
        summary = json.loads(err_text.strip().splitlines()[-1])
        check(summary["p50_ms"] is not None and summary["p99_ms"] is not None,
              f"cli.serve (stdin) summary {summary}")
        hist = snap["latency_s"]["total"]
        print(f"cli.serve (stdin, GRAFT_METRICS_PORT=0): {len(want)} lines equal; "
              f"/snapshot.json serve.latency_s count {hist['count']} "
              f"(p50 {hist.get('p50')}, p99 {hist.get('p99')} s); summary p50_ms "
              f"{summary['p50_ms']}, p99_ms {summary['p99_ms']}; {secs:.1f} s with start-up")


def serving_phase(device, reset_counts, counts, card_label: str, docs,
                  wiki) -> tuple[dict, dict]:
    """Phase 11 (see the module docstring); every check raises on failure.
    Returns the launches of the path (the prior's PageRank) and 11b's
    queries/s by scoring."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import tfidf as tops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import percentile

    queries = serving_queries(docs, SERVE_QUERIES, SERVE_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        index, launched = build_serving_index(tmp, docs, device, reset_counts, counts,
                                              card_label)
        got = check_scorers(tops, serving, index, queries, device, reset_counts, counts,
                            card_label)
        print(f"phase 11a (scorers): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        qps = bench_server(serving, percentile, index, queries, got["canon"], tops, device,
                           card_label)
        print(f"phase 11b (server): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli_phase(serving, index, queries, device, card_label)
        print(f"phase 11d (cli): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    segments_phase(serving, wiki, device, card_label)
    print(f"phase 11c (segments): {time.perf_counter() - t0:.1f} s")
    return launched, qps



# Phase 12: PageRank checkpoints and resume, and the graph workloads, on the
# main path's graph.  PPR is bench.py's shape (bench.py:718-724): B = 8
# single-node queries drawn from seed 7, 10 iterations, redistribute,
# uniform.  HITS runs 100 iterations at tol 1e-8, components to their
# fixpoint; cli.workloads runs on a small graph.  Timed medians take
# WORKLOAD_RUNS runs.
CKPT_EVERY, WORKLOAD_RUNS = 5, 5
PPR_BATCH, PPR_ITERS, PPR_IMPLS = 8, 10, ("cumsum", "segment", "pallas", "hybrid")
# the kernels a step of each impl's SpMV launches, once a row
PPR_KERNELS = {"cumsum": ("cumsum",), "segment": ("segment",), "pallas": ("spmv",),
               "hybrid": ("cumsum", "rowsum", "segment")}
HITS_ITERS, HITS_TOL = 100, 1e-8
WORKLOAD_CLI_GRAPH = (20_000, 100_000, 7)
CC_SPARSE_GRAPH = (200_000, 150_000, 7)  # nodes, edges, seed: many components


def bits_differ(a: np.ndarray, b: np.ndarray) -> int:
    """Entries of two float arrays of one shape whose bits differ."""
    view = np.int32 if a.dtype == np.float32 else np.int64
    return int((np.ascontiguousarray(a).view(view) != np.ascontiguousarray(b).view(view)).sum())


def add_counts(total: dict, launched: dict) -> None:
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v


def pagerank_checkpoint_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """12a: for segment, pallas and hybrid in float32 and float64, an
    unbroken 20-iteration run, a "killed" 10-iteration run checkpointing
    every 5, and its resume to 20: the resumed ranks equal the unbroken
    run's bit for bit.  The CLI once the same way; the checkpoints' cost.
    Returns the resumed runs' launches."""
    import dataclasses

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as cli
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import checkpoint as ckpt
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    base = PageRankConfig(iterations=ITERS, dangling="redistribute", init="uniform")
    total: dict = {}
    unbroken = {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl in MAIN_IMPLS:
            for dtype in ("float32", "float64"):
                cfg = dataclasses.replace(base, dtype=dtype, spmv_impl=impl)
                full = run_pagerank(graph, cfg, device="cuda")
                unbroken[(impl, dtype)] = full.ranks
                ck = dict(checkpoint_every=CKPT_EVERY,
                          checkpoint_dir=os.path.join(tmp, f"{impl}-{dtype}"))
                killed = run_pagerank(graph, dataclasses.replace(cfg, iterations=ITERS // 2,
                                                                 **ck), device="cuda")
                saved = [r["iter"] for r in killed.metrics.records if r.get("event") == "checkpoint"]
                reset_counts()
                res = run_pagerank(graph, dataclasses.replace(cfg, **ck), resume=True,
                                   device="cuda")
                launched = counts()
                add_counts(total, launched)
                start = [r["start_iter"] for r in res.metrics.records if r.get("event") == "resume"]
                differ = bits_differ(res.ranks, full.ranks)
                print(f"checkpoints {impl} {dtype}: killed at {ITERS // 2} (saved {saved}), "
                      f"resumed at {start} to {res.iterations}: {differ} of {graph.n_nodes} "
                      f"entries differ from the unbroken run; launches {launched}")
                check(saved == [CKPT_EVERY] and start == [CKPT_EVERY],
                      f"checkpoints {impl} {dtype}: saved {saved}, resumed at {start}")
                check(res.iterations == ITERS and res.ranks.dtype == np.dtype(dtype),
                      f"checkpoints {impl} {dtype}: {res.iterations} iterations, {res.ranks.dtype}")
                check(differ == 0, f"checkpoints {impl} {dtype}: resumed ranks differ in "
                                   f"{differ} entries from the unbroken run")
                check(all(launched[k] == ITERS - CKPT_EVERY for k in PPR_KERNELS[impl]),
                      f"checkpoints {impl} {dtype}: the resumed run launched {launched}")

        # the CLI, killed at 10 and resumed to 20 (segment, float32)
        d, out = os.path.join(tmp, "cli"), os.path.join(tmp, "cli.tsv")
        spec = f"synthetic:{N_NODES},{N_EDGES},{SEED}"
        flags = ["--dangling", "redistribute", "--init", "uniform", "--device", "cuda",
                 "--checkpoint-dir", d, "--checkpoint-every", str(CKPT_EVERY), "--output", out,
                 "--tuned-profile", "off"]
        t0 = time.perf_counter()
        check(cli.main([spec, str(ITERS // 2), *flags]) == 0, "checkpointed CLI run failed")
        check(cli.main([spec, str(ITERS), *flags, "--resume"]) == 0, "resumed CLI run failed")
        latest = os.path.basename(ckpt.latest_checkpoint(d))
        table = np.loadtxt(out, dtype=np.float64, delimiter="\t", ndmin=2)
        rows = np.searchsorted(graph.node_ids, table[:, 0].astype(np.int64))
        expect = unbroken[("segment", "float32")][rows].astype(np.float64)
        err = float(np.abs(table[:, 1] - expect).max())
        print(f"checkpoints cli: killed at {ITERS // 2}, resumed to {ITERS} (latest {latest}), "
              f"{len(rows)} lines, max abs diff vs the unbroken segment run {err:.3g}; "
              f"{time.perf_counter() - t0:.1f} s for both runs with the graph build")
        check(len(rows) == graph.n_nodes and latest == f"ckpt_{ITERS - CKPT_EVERY:08d}.npz",
              f"checkpoints cli: {len(rows)} lines, latest {latest}")
        check(err <= 1e-9 * float(expect.max()), "checkpoints cli: ranks differ from the API run")

        # the checkpoints' cost: run wall less put_graph, with and without
        cfg = dataclasses.replace(base, dtype="float32", spmv_impl="segment")

        def loop_ms(c) -> float:
            t0 = time.perf_counter()
            r = run_pagerank(graph, c, device="cuda")
            wall = time.perf_counter() - t0
            put = next(x for x in r.metrics.records if x.get("event") == "put_graph")
            return (wall - put["preprocess_secs"]) * 1e3

        with_ck = dataclasses.replace(cfg, checkpoint_every=CKPT_EVERY,
                                      checkpoint_dir=os.path.join(tmp, "cost"))
        plain = float(np.median([loop_ms(cfg) for _ in range(WORKLOAD_RUNS)]))
        ckd = float(np.median([loop_ms(with_ck) for _ in range(WORKLOAD_RUNS)]))
        n_ck = ITERS // CKPT_EVERY - 1
        print(f"checkpoint cost (segment, float32, {card_label}): 20-iteration run less "
              f"put_graph {plain:.3f} ms, with checkpoint_every={CKPT_EVERY} {ckd:.3f} ms "
              f"(medians of {WORKLOAD_RUNS}); {(ckd - plain) / n_ck:.3f} ms a checkpoint "
              f"({n_ck} a run, {graph.n_nodes * 4} bytes of ranks each)")
    return total


def ppr_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """12b: bench.py's PPR batch through cumsum, segment, pallas and hybrid:
    float64 rows within 1e-12 of single-query run_pagerank, float32 rows
    within L1 1e-3 of float64, the API run and five timed runs equal bit
    for bit, B launches of the impl's kernels a step.  Returns the API runs'
    launches."""
    import dataclasses

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (
        put_graph_for,
        run_pagerank,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    n = graph.n_nodes
    rng = np.random.default_rng(SEED)
    queries = [[int(graph.node_ids[i])] for i in rng.integers(0, n, size=PPR_BATCH)]
    total: dict = {}
    for impl in PPR_IMPLS:
        ranks = {}
        for dtype in ("float64", "float32"):
            cfg = PageRankConfig(iterations=PPR_ITERS, dangling="redistribute", init="uniform",
                                 dtype=dtype, spmv_impl=impl)
            reset_counts()
            res = ppr.run_ppr_batch(graph, cfg, queries, device="cuda")
            launched = counts()
            add_counts(total, launched)
            ranks[dtype] = res.ranks
            want = {k: 0 for k in launched}
            want.update({k: PPR_BATCH * PPR_ITERS for k in PPR_KERNELS[impl]})
            check(res.ranks.shape == (PPR_BATCH, n) and bool(np.isfinite(res.ranks).all()),
                  f"ppr {impl} {dtype}: ranks not finite or of shape {res.ranks.shape}")
            check(launched == want, f"ppr {impl} {dtype}: launches {launched}, wanted {want}")
            # the loop alone, over one device graph, as bench.py times it
            dg = put_graph_for(graph, cfg, "cuda")
            e_b = torch.from_numpy(ppr.restart_batch(graph, cfg, queries)).to("cuda")
            r0 = torch.from_numpy(np.broadcast_to(ops.init_ranks(n, cfg),
                                                  (PPR_BATCH, n)).copy()).to("cuda")
            runner = ppr.make_ppr_batch_runner(n, cfg)
            runner(dg, r0, e_b)
            walls, differ = [], 0
            for _ in range(WORKLOAD_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = runner(dg, r0, e_b)[0]
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                differ = max(differ, bits_differ(out.cpu().numpy(), res.ranks))
            wall = float(np.median(walls))
            print(f"ppr {impl} {dtype} ({card_label}): B={PPR_BATCH} x {PPR_ITERS} iterations, "
                  f"loop {wall * 1e3:.3f} ms median of {WORKLOAD_RUNS} (min "
                  f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}), "
                  f"{PPR_BATCH / wall:.2f} queries/s; launches {launched}; "
                  f"{differ} entries differ over {WORKLOAD_RUNS + 1} runs")
            check(differ == 0, f"ppr {impl} {dtype}: two runs differ in {differ} entries")
            del dg
        worst = 0.0
        for qi, q in enumerate(queries):
            one = run_pagerank(graph, PageRankConfig(
                iterations=PPR_ITERS, dangling="redistribute", init="uniform", dtype="float64",
                spmv_impl=impl, personalize=tuple(q)), device="cuda").ranks
            worst = max(worst, float(np.abs(ranks["float64"][qi] - one).max()))
        l1 = float(np.abs(ranks["float32"].astype(np.float64) - ranks["float64"]).sum(axis=1).max())
        print(f"ppr {impl}: float64 rows vs single-query run_pagerank max abs {worst:.3g}; "
              f"float32 vs float64 worst row L1 {l1:.3g}")
        check(worst <= 1e-12, f"ppr {impl}: a row is {worst} from its single-query run")
        check(l1 <= 1e-3, f"ppr {impl}: float32 row L1 {l1} from float64")
    return total


def hits_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """12c: HITS at 100 iterations, tol 1e-8, float32 and float64: five runs
    of each equal bit for bit, two segment launches a step, float64 within
    1e-12 of the CPU run.  Returns the first runs' launches."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import HitsConfig

    total: dict = {}
    for dtype in ("float32", "float64"):
        cfg = HitsConfig(iterations=HITS_ITERS, tol=HITS_TOL, dtype=dtype)
        reset_counts()
        first = run_hits(graph, cfg, device="cuda")
        launched = counts()
        add_counts(total, launched)
        rates, differ = [], 0
        for res in [first] + [run_hits(graph, cfg, device="cuda") for _ in range(WORKLOAD_RUNS - 1)]:
            rates.append(last_segment(res.metrics)["iters_per_sec"])
            differ = max(differ, bits_differ(res.hubs, first.hubs),
                         bits_differ(res.authorities, first.authorities))
        want = {k: 0 for k in launched}
        want["segment"] = 2 * first.iterations
        print(f"hits {dtype} ({card_label}): {first.iterations} iterations, delta "
              f"{first.l1_delta:.3g}, {float(np.median(rates)):.2f} iterations/s median of "
              f"{WORKLOAD_RUNS} (min {min(rates):.2f}, max {max(rates):.2f}); launches "
              f"{launched}; {differ} entries differ over {WORKLOAD_RUNS} runs")
        check(bool(np.isfinite(first.hubs).all() and np.isfinite(first.authorities).all()),
              f"hits {dtype}: not finite")
        check(launched == want, f"hits {dtype}: launches {launched}, wanted {want}")
        check(differ == 0, f"hits {dtype}: runs differ in {differ} entries")
        if dtype == "float64":
            t0 = time.perf_counter()
            cpu = run_hits(graph, cfg, device="cpu")
            err = max(float(np.abs(cpu.hubs - first.hubs).max()),
                      float(np.abs(cpu.authorities - first.authorities).max()))
            print(f"hits float64 vs device='cpu': {cpu.iterations} iterations, max abs "
                  f"{err:.3g} ({time.perf_counter() - t0:.1f} s on the CPU)")
            check(cpu.iterations == first.iterations and err <= 1e-12,
                  f"hits float64: {err} from the CPU run ({cpu.iterations} iterations)")
    return total


def components_phase(graph, reset_counts, counts, card_label: str) -> None:
    """12d: connected components to the fixpoint on the main path's graph
    (one weak component) and on a sparse graph of many: labels equal to
    scipy's weak components relabelled to each one's smallest id; no
    kernel; rounds/s, the median of WORKLOAD_RUNS runs."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import (
        run_components,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw

    sparse = synthetic_powerlaw(*CC_SPARSE_GRAPH[:2], seed=CC_SPARSE_GRAPH[2])
    for label, g in (("main path", graph), ("sparse", sparse)):
        n = g.n_nodes
        reset_counts()
        res = run_components(g, device="cuda")
        launched = counts()
        k, comp = connected_components(
            csr_matrix((np.ones(g.n_edges, np.int8), (g.src, g.dst)), shape=(n, n)),
            directed=True, connection="weak")
        smallest = np.full(k, n, np.int64)
        np.minimum.at(smallest, comp, np.arange(n))
        wrong = int((res.labels != smallest[comp]).sum())
        runs = [res] + [run_components(g, device="cuda") for _ in range(WORKLOAD_RUNS - 1)]
        steps = [next(r for r in x.metrics.records if "iters_per_sec" in r) for x in runs]
        rate = float(np.median([st["iters_per_sec"] for st in steps]))
        print(f"components {label} ({n} nodes, {g.n_edges} edges; {card_label}): "
              f"{res.iterations} rounds, converged {res.converged}, {res.n_components} "
              f"components (scipy {k}), {rate:.2f} rounds/s median of {WORKLOAD_RUNS} (loop "
              f"ms {', '.join(f'{st['secs'] * 1e3:.3f}' for st in steps)}); {wrong} labels "
              f"differ from scipy's; launches {launched}")
        check(res.converged and res.n_components == k and wrong == 0,
              f"components {label}: {wrong} labels differ from scipy's, "
              f"{res.n_components} components vs {k}")
        check(all(x.labels.tobytes() == res.labels.tobytes() for x in runs),
              f"components {label}: runs differ")
        check(not any(launched.values()), f"components {label} launched {launched}")


def workloads_cli_phase() -> None:
    """12e: ``cli.workloads`` ppr, hits and cc once each on a small graph;
    their lines equal what the API gives on the card."""
    import contextlib
    import io

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import workloads as wcli
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import (
        run_components,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import run_ppr_batch
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        HitsConfig,
        PageRankConfig,
    )

    g = synthetic_powerlaw(*WORKLOAD_CLI_GRAPH[:2], seed=WORKLOAD_CLI_GRAPH[2])
    spec = "synthetic:" + ",".join(str(x) for x in WORKLOAD_CLI_GRAPH)
    ids = [int(x) for x in g.node_ids[[0, 5, 9]]]
    queries = [[ids[0]], [ids[1], ids[2]]]

    def top(vec, k: int = 10):
        return vec.argsort()[::-1][:k]

    ranks = run_ppr_batch(g, PageRankConfig(iterations=50, tol=1e-8, dangling="redistribute",
                                            init="uniform"), queries, device="cuda").ranks
    hits = run_hits(g, HitsConfig(), device="cuda")
    labels = run_components(g, device="cuda").labels
    want = {
        "ppr": [f"{qi}\t{g.node_ids[i]}\t{ranks[qi][i]:.10g}"
                for qi in range(len(queries)) for i in top(ranks[qi])],
        "hits": [f"{name}\t{g.node_ids[i]}\t{vec[i]:.10g}"
                 for name, vec in (("hub", hits.hubs), ("auth", hits.authorities))
                 for i in top(vec)],
        "cc": [f"{g.node_ids[i]}\t{g.node_ids[lab]}" for i, lab in enumerate(labels)],
    }
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cc.tsv")
        for kind, argv in (("ppr", ["--queries", str(ids[0]), f"{ids[1]},{ids[2]}"]),
                           ("hits", []), ("cc", ["--output", out])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = wcli.main([kind, spec, *argv, "--device", "cuda"])
            check(rc == 0, f"cli.workloads {kind} exited {rc}")
            lines = buf.getvalue().splitlines() if kind != "cc" else open(out).read().splitlines()
            print(f"cli.workloads {kind}: {len(lines)} lines, equal to the API's: "
                  f"{lines == want[kind]}")
            check(lines == want[kind], f"cli.workloads {kind}: lines differ from the API's")


def workloads_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """Phase 12 (see the module docstring); every check raises on failure.
    Returns the launches of 12a-12c by kernel, for the kernels line."""
    by_phase = {}
    for label, name, fn in (("12a (pagerank checkpoints)", "pagerank_resume",
                             pagerank_checkpoint_phase),
                            ("12b (ppr)", "ppr", ppr_phase), ("12c (hits)", "hits", hits_phase)):
        t0 = time.perf_counter()
        by_phase[name] = fn(graph, reset_counts, counts, card_label)
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    components_phase(graph, reset_counts, counts, card_label)
    print(f"phase 12d (components): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    workloads_cli_phase()
    print(f"phase 12e (cli.workloads): {time.perf_counter() - t0:.1f} s")
    return by_phase


# Phase 13: chaos on the card.  Faults are injected (resilience/chaos.py)
# at the guarded sites of the main path's graph (13a-13c), of phase 9's
# config-2 stand-in (13d) and of phase 11's index and segments (13e); every
# faulted run is held to its unfaulted run bit for bit.  13b runs HITS on a
# side stream, so a retried pull the watchdog thread did not run on the
# caller's stream would read the delta before it is computed.  HITS reads
# hits_delta_sync once a run (tol > 0 is one segment), so 13b's third run
# under one plan takes the hang.  13f times the guard itself.
CHAOS_PLANS = ("pagerank_step:fail@2", "pagerank_ckpt_pull:fail@1",
               "pagerank_result_pull:fail@1", "*:fail@%3")
HANG_PLAN, HANG_S, DEADLINE_S, HANG_RUNS = "hits_delta_sync:hang@3:2.0", 2.0, 0.5, 3
LOST_PLAN, LOST_CKPT = "pagerank_step:lost@3", 10
STREAM_PLAN = ("tfidf_chunk_sync:fail@%3;ingest_h2d_put:fail@2;ingest_h2d_wait:fail@4;"
               "tfidf_df_commit:fail@1")
SOURCE_DIES_AT = 5
SERVE_PLAN, MERGE_PLAN = "serve_dispatch:fail@%5;serve_pull:fail@7", "segment_merge:fail@1"
GUARD_CALLS = 10_000


class SourceDied(Exception):
    """The source of 13d's second run."""


class FaultEvents:
    """The port's obs events while the context is open, by kind."""

    def __enter__(self):
        from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs

        self._obs = obs
        self.sink = obs.MemorySink()
        obs.bus().attach(self.sink)
        return self

    def __exit__(self, *exc) -> None:
        self._obs.bus().detach(self.sink)

    def of(self, kind: str) -> list:
        return [e for e in self.sink.events if e["kind"] == kind]

    def by_site(self, kind: str) -> dict:
        out: dict = {}
        for e in self.of(kind):
            out[e["site"]] = out.get(e["site"], 0) + 1
        return out


def chaos_pagerank_phase(graph, reset_counts, counts, card_label: str) -> tuple[dict, dict]:
    """13a: segment, pallas and hybrid in float32 and float64, checkpoints
    every 5, under each of CHAOS_PLANS: ranks equal to the unfaulted run's
    bit for bit, one retry per injection, the unfaulted run's launches.
    Returns the faulted runs' launches and the unfaulted ranks."""
    import dataclasses

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    base = PageRankConfig(iterations=ITERS, dangling="redistribute", init="uniform",
                          checkpoint_every=CKPT_EVERY)
    total: dict = {}
    unbroken: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl in MAIN_IMPLS:
            for dtype in ("float32", "float64"):
                def cfg(tag: str):
                    return dataclasses.replace(
                        base, dtype=dtype, spmv_impl=impl,
                        checkpoint_dir=os.path.join(tmp, f"{impl}-{dtype}-{tag}"))

                reset_counts()
                full = run_pagerank(graph, cfg("clean"), device="cuda")
                want = counts()
                unbroken[(impl, dtype)] = full.ranks
                for k, plan in enumerate(CHAOS_PLANS):
                    with FaultEvents() as ev, chaos.inject(plan):
                        reset_counts()
                        res = run_pagerank(graph, cfg(f"plan{k}"), device="cuda")
                        launched = counts()
                    add_counts(total, launched)
                    injected, retried = ev.by_site("chaos"), ev.by_site("retry")
                    differ = bits_differ(res.ranks, full.ranks)
                    print(f"chaos pagerank {impl} {dtype} under {plan!r}: injected {injected}, "
                          f"retried {retried}; {differ} of {graph.n_nodes} entries differ from "
                          f"the unfaulted run; launches {launched} (unfaulted {want})")
                    check(differ == 0 and res.iterations == ITERS,
                          f"chaos pagerank {impl} {dtype} {plan}: {differ} entries differ")
                    check(injected and retried == injected,
                          f"chaos pagerank {impl} {dtype} {plan}: injected {injected}, "
                          f"retried {retried}")
                    check(launched == want, f"chaos pagerank {impl} {dtype} {plan}: launched "
                                            f"{launched}, the unfaulted run {want}")
    return total, unbroken


def chaos_watchdog_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """13b: HITS (tol 1e-8, float32) on a side stream, HANG_RUNS runs under
    HANG_PLAN with GRAFT_SYNC_DEADLINE_S=DEADLINE_S: one watchdog event,
    scores equal to the unfaulted run's (and the default stream's) bit for
    bit, the faulted run within HANG_S of the unfaulted one.  Returns the
    faulted runs' launches."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import HitsConfig

    cfg = HitsConfig(iterations=HITS_ITERS, tol=HITS_TOL, dtype="float32")
    side = torch.cuda.Stream()

    def run():
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            res = run_hits(graph, cfg, device="cuda")
            return res, time.perf_counter() - t0

    def same(a, b) -> bool:
        return (bits_differ(a.hubs, b.hubs) == 0
                and bits_differ(a.authorities, b.authorities) == 0)

    default = run_hits(graph, cfg, device="cuda")
    run()  # the side stream's first blocks
    clean, clean_wall = run()
    check(same(clean, default), "chaos hits: the side stream's scores differ from the default's")
    old = os.environ.get("GRAFT_SYNC_DEADLINE_S")
    os.environ["GRAFT_SYNC_DEADLINE_S"] = str(DEADLINE_S)
    total: dict = {}
    runs = []
    try:
        with FaultEvents() as ev, chaos.inject(HANG_PLAN):
            for _ in range(HANG_RUNS):
                reset_counts()
                res, wall = run()
                launched = counts()
                add_counts(total, launched)
                runs.append((res, wall, launched))
    finally:
        if old is None:
            os.environ.pop("GRAFT_SYNC_DEADLINE_S", None)
        else:
            os.environ["GRAFT_SYNC_DEADLINE_S"] = old
    watchdogs = ev.of("watchdog")
    walls = [w for _, w, _ in runs]
    print(f"chaos hits watchdog ({card_label}): {HANG_PLAN!r}, deadline {DEADLINE_S} s, side "
          f"stream: {len(watchdogs)} watchdog event(s) at {[e['site'] for e in watchdogs]}, "
          f"retried {ev.by_site('retry')}; run walls {', '.join(f'{w:.3f}' for w in walls)} s "
          f"(the last faulted) against {clean_wall:.3f} s unfaulted; {clean.iterations} "
          f"iterations; launches {[r[2] for r in runs]}")
    check(len(watchdogs) == 1 and watchdogs[0]["site"] == "hits_delta_sync",
          f"chaos hits: watchdog events {watchdogs}")
    check(ev.by_site("retry") == {"hits_delta_sync": 1}, "chaos hits: not one retry")
    for res, _, launched in runs:
        check(same(res, clean), "chaos hits: a run's scores differ from the unfaulted run's")
        want = {k: 0 for k in launched}
        want["segment"] = 2 * clean.iterations
        check(launched == want, f"chaos hits: launched {launched}, wanted {want}")
    check(DEADLINE_S <= walls[-1] < clean_wall + HANG_S,
          f"chaos hits: the faulted run took {walls[-1]:.3f} s, unfaulted {clean_wall:.3f} s")
    return total


def chaos_exhausted_phase(graph, unbroken: dict, reset_counts, counts,
                          card_label: str) -> dict:
    """13c: LOST_PLAN under segment float32, checkpoints every 5:
    ResilienceExhausted naming the iteration-10 checkpoint, an ``exhausted``
    event and no ``degraded``; the resumed run equal to the unbroken one bit
    for bit.  Returns the resumed run's launches."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import ResilienceExhausted
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    with tempfile.TemporaryDirectory() as tmp:
        cfg = PageRankConfig(iterations=ITERS, dangling="redistribute", init="uniform",
                             spmv_impl="segment", checkpoint_every=CKPT_EVERY,
                             checkpoint_dir=tmp)
        err = None
        with FaultEvents() as ev, chaos.inject(LOST_PLAN):
            try:
                run_pagerank(graph, cfg, device="cuda")
            except ResilienceExhausted as exc:
                err = exc
        check(err is not None, f"chaos lost: {LOST_PLAN} did not raise ResilienceExhausted")
        latest = os.path.basename(err.last_checkpoint or "")
        reset_counts()
        res = run_pagerank(graph, cfg, resume=True, device="cuda")
        launched = counts()
    differ = bits_differ(res.ranks, unbroken[("segment", "float32")])
    print(f"chaos lost ({card_label}): {LOST_PLAN!r} raised ResilienceExhausted at "
          f"{err.site!r} after {err.attempts} attempt(s), last checkpoint {latest}; events "
          f"exhausted {len(ev.of('exhausted'))}, degraded {len(ev.of('degraded'))}; resumed "
          f"to {res.iterations}: {differ} entries differ from the unbroken run; launches "
          f"{launched}")
    check(latest == f"ckpt_{LOST_CKPT:08d}.npz", f"chaos lost: last checkpoint {latest}")
    check(len(ev.of("exhausted")) >= 1 and not ev.of("degraded"),
          "chaos lost: wanted exhausted and no degraded event")
    check(differ == 0 and res.iterations == ITERS, f"chaos lost: resumed run differs in {differ}")
    check(launched["segment"] == ITERS - LOST_CKPT, f"chaos lost: resumed run launched {launched}")
    return launched


def chaos_streaming_phase(device, docs, knobs: dict, chunk_docs: int, card_label: str) -> None:
    """13d: phase 9's config-2 stand-in, pipelined, under STREAM_PLAN: the
    sorted COO, counts, weights, DF and IDF equal to the batch run's bit for
    bit, one retry per injection at every site of the plan; then a source
    that raises at chunk SOURCE_DIES_AT under the same plan raises once and
    is not retried."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    chunks = chunked(docs, chunk_docs)
    batch = tm.run_tfidf(docs, tcfg.TfidfConfig(vocab_bits=knobs["vocab_bits"]), device=device)
    cfg = tcfg.TfidfConfig(**knobs)
    t0 = time.perf_counter()
    with FaultEvents() as ev, chaos.inject(STREAM_PLAN):
        out = tm.run_tfidf_streaming(iter(chunks), cfg, device=device)
    secs = time.perf_counter() - t0
    check_same_coo(out, batch, "chaos stream config-2")
    injected, retried = ev.by_site("chaos"), ev.by_site("retry")
    sites = {spec.split(":")[0] for spec in STREAM_PLAN.split(";")}
    print(f"chaos stream config-2 ({card_label}): {STREAM_PLAN!r} in {secs:.3f} s; injected "
          f"{injected}, retried {retried}; sorted COO, counts, weights, df and idf equal to "
          "batch bit for bit")
    check(set(injected) == sites and retried == injected,
          f"chaos stream: injected {injected}, retried {retried}")

    raised = []

    def dying():
        yield from chunks[:SOURCE_DIES_AT]
        raised.append(SOURCE_DIES_AT)
        raise SourceDied(f"source died at chunk {SOURCE_DIES_AT}")

    died = False
    with FaultEvents() as ev, chaos.inject(STREAM_PLAN):
        try:
            tm.run_tfidf_streaming(dying(), cfg, device=device)
        except SourceDied:
            died = True
    print(f"chaos stream source fault: raised {len(raised)} time(s) at chunk {SOURCE_DIES_AT}, "
          f"reached the caller: {died}; retried {ev.by_site('retry')}")
    check(died and raised == [SOURCE_DIES_AT], "chaos stream: the source fault was retried "
                                               "or lost")


def chaos_serving_phase(device, docs, wiki, reset_counts, counts, card_label: str) -> None:
    """13e: phase 11b's index served to SERVE_QUERIES queries under
    SERVE_PLAN, every answer equal to the unfaulted server's bit for bit and
    no request failed; then ``merge_once`` over 11c's four segments under
    MERGE_PLAN, the merged set equal to the unfaulted merge's."""
    import shutil

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    queries = serving_queries(docs, SERVE_QUERIES, SERVE_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        index, _ = build_serving_index(tmp, docs, device, reset_counts, counts, card_label)
        cfg = serving.ServeConfig(cache_size=0)
        with serving.TfidfServer(index, cfg, device=device) as srv:
            want = serve_all(srv, queries, "tfidf")
        with FaultEvents() as ev, chaos.inject(SERVE_PLAN):
            with serving.TfidfServer(index, cfg, device=device) as srv:
                t0 = time.perf_counter()
                got = serve_all(srv, queries, "tfidf")
                secs = time.perf_counter() - t0
                stats = srv.stats()
    differ = sum(not (a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes())
                 for a, b in zip(got, want))
    retried = ev.by_site("retry")
    print(f"chaos serve ({card_label}): {SERVE_PLAN!r}, {len(queries)} queries in {secs:.2f} s "
          f"({len(queries) / secs:.1f} queries/s, one submitter), {stats['batches']} batches, "
          f"{stats['batch_errors']} batch errors; retried {retried}; {differ} answers differ "
          "from the unfaulted server's")
    check(stats["batch_errors"] == 0 and len(got) == len(queries), "chaos serve: requests failed")
    check(differ == 0, f"chaos serve: {differ} answers differ")
    check(retried.get("serve_dispatch", 0) > 0 and retried.get("serve_pull", 0) == 1,
          f"chaos serve: retried {retried}")

    scfg = tcfg.TfidfConfig(vocab_bits=TFIDF_BITS, ngram=2, idf_mode="smooth", l2_normalize=True)
    with tempfile.TemporaryDirectory() as tmp:
        clean_dir, faulted_dir = os.path.join(tmp, "clean"), os.path.join(tmp, "faulted")
        per = len(wiki) // SEGMENTS
        base = 0
        for s in range(SEGMENTS):
            part = wiki[s * per:(s + 1) * per if s < SEGMENTS - 1 else len(wiki)]
            out = run_tfidf(part, scfg, device=device)
            ref = sgm.seal_segment(clean_dir, out, scfg, doc_base=base, bm25=tcfg.Bm25Config())
            sgm.commit_append(clean_dir, ref, scfg.config_hash())
            base += out.n_docs
        shutil.copytree(clean_dir, faulted_dir)
        merged = {}
        for tag, d in (("clean", clean_dir), ("faulted", faulted_dir)):
            merger = sgm.SegmentMerger(d, scfg, max_segments=SEGMENTS - 1)
            with FaultEvents() as ev, (chaos.inject(MERGE_PLAN) if tag == "faulted"
                                       else contextlib.nullcontext()):
                check(merger.merge_once(), f"chaos merge {tag}: merge_once merged nothing")
            merged[tag] = (sgm.load_segment_set(d), ev.by_site("retry"))
    (a, _), (b, retried) = merged["clean"], merged["faulted"]
    same = len(a.segments) == len(b.segments) == SEGMENTS - 1 and all(
        x.ref.doc_base == y.ref.doc_base and x.index.n_docs == y.index.n_docs
        and x.index.doc.tobytes() == y.index.doc.tobytes()
        and x.index.term.tobytes() == y.index.term.tobytes()
        and sorted(x.weights) == sorted(y.weights)
        and all(x.weights[r].tobytes() == y.weights[r].tobytes() for r in x.weights)
        for x, y in zip(a.segments, b.segments))
    print(f"chaos merge: {MERGE_PLAN!r} over {SEGMENTS} config-5 segments, retried {retried}; "
          f"{len(b.segments)} segments, postings and weights equal to the unfaulted merge: "
          f"{same}")
    check(retried == {"segment_merge": 1} and same, "chaos merge: the faulted merge differs")


def guard_cost_phase(loop_ms: dict, qps: dict, card_label: str) -> None:
    """13f: the median of GUARD_CALLS calls of ``run_guarded`` with no plan
    installed, beside phase 4b's segment loop and phase 11b's queries/s,
    both measured through the guarded sites."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import executor as rx

    check(chaos.active() is None, "guard cost: a chaos plan is installed")
    ns = []
    for _ in range(GUARD_CALLS):
        t0 = time.perf_counter_ns()
        rx.run_guarded(lambda: None, site="x")
        ns.append(time.perf_counter_ns() - t0)
    us = np.array(ns) / 1e3
    print(f"guard cost ({card_label}): run_guarded(lambda: None, site='x') with no plan, median "
          f"{float(np.median(us)):.3f} us of {GUARD_CALLS} calls (min {float(us.min()):.3f}, "
          f"p99 {float(np.percentile(us, 99)):.3f}); through the guarded sites: phase 4b segment "
          f"loop {loop_ms['segment']:.3f} ms ({ITERS} iterations, median of 5), phase 11b "
          f"queries/s coo {qps['coo']:.1f}, impacted {qps['impacted']:.1f}")


def chaos_phase(graph, stream: dict, loop_ms: dict, qps: dict, reset_counts, counts,
                card_label: str) -> dict:
    """Phase 13 (see the module docstring); every check raises on failure.
    Returns the launches of 13a-13c's counted runs, for the kernels line."""
    total: dict = {}
    t0 = time.perf_counter()
    launched, unbroken = chaos_pagerank_phase(graph, reset_counts, counts, card_label)
    add_counts(total, launched)
    print(f"phase 13a (pagerank retries): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(total, chaos_watchdog_phase(graph, reset_counts, counts, card_label))
    print(f"phase 13b (watchdog): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(total, chaos_exhausted_phase(graph, unbroken, reset_counts, counts, card_label))
    print(f"phase 13c (exhausted, resume): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    chaos_streaming_phase(torch.device("cuda"), stream["docs"], stream["knobs"],
                          stream["chunk_docs"], card_label)
    print(f"phase 13d (streaming): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    chaos_serving_phase(torch.device("cuda"), stream["docs"], stream["wiki"], reset_counts,
                        counts, card_label)
    print(f"phase 13e (serving, merge): {time.perf_counter() - t0:.1f} s")
    guard_cost_phase(loop_ms, qps, card_label)
    return total


# Phase 14: a lost device hands the run to the CPU (resilience/elastic.py,
# the rungs of dataflow/fixpoint.py, the streaming rollback of
# models/tfidf.py), on phase 12's inputs.  A loss that names the card
# (device_lost@dev:0) takes the salvage: the newest checkpoint, then the CPU
# to the end of the run.  A whole-backend loss (lost) and a kernel's own
# fault exhaust with the newest checkpoint (14b): the port has no
# per-segment cpu rung.  A device_lost fires at its site's first
# guarded call, so a loss mid-run comes from a site first reached mid-run,
# the result pull, or a run resumed from a snapshot.  Each row: the site,
# the iteration of the snapshot the salvage takes, the iterations the card
# runs before the loss.
DEGRADE_SITES = (("pagerank_step", LOST_CKPT, 0), ("pagerank_delta_sync", 0, CKPT_EVERY),
                 ("pagerank_ckpt_pull", 0, CKPT_EVERY),
                 ("pagerank_result_pull", ITERS - CKPT_EVERY, ITERS))
DEGRADE_IMPLS = (("pallas", "float32"), ("hybrid", "float32"), ("segment", "float64"))
BACKEND_LOSS = "pagerank_delta_sync:lost@3"
KERNEL_FAULT = "CUDA error: an illegal memory access was encountered"
WORKLOAD_LOSSES = ("ppr_delta_sync", "ppr_result_pull", "hits_delta_sync", "cc_delta_sync")
STREAM_LOSSES, STREAM_CKPT_EVERY = ("ingest_h2d_put", "ingest_h2d_wait"), 4
# 14d's loss after a commit: the stream's first two thirds (of its
# 512-document chunks, packed to 2^18 tokens), checkpointed, then the whole
# stream resumed from that snapshot, losing the card at its next commit
STREAM_COMMIT_LOSS = "tfidf_df_commit"
LOSS_DEVICE = 0


class DegradedCount:
    """An obs sink counting the port's ``degraded`` events from its attach
    on (14e reads it after every phase)."""

    def __init__(self) -> None:
        self.n = 0

    def emit(self, event: dict) -> None:
        if event["kind"] == "degraded":
            self.n += 1

    def close(self) -> None:
        pass


def lost_run(fn, site: str):
    """``fn()`` under ``<site>:device_lost@dev:0`` from an empty health
    registry, left empty after: (result, wall s, degraded events, exhausted
    events)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic

    elastic.reset_health()
    try:
        with FaultEvents() as ev, chaos.inject(f"{site}:device_lost@dev:{LOSS_DEVICE}"):
            t0 = time.perf_counter()
            res = fn()
            wall = time.perf_counter() - t0
    finally:
        elastic.reset_health()
    return res, wall, ev.of("degraded"), ev.of("exhausted")


def check_one_degrade(label: str, site: str, deg: list, exh: list, want_site: str) -> dict:
    """One ``degraded`` event, ladder cpu, at ``want_site``; an ``exhausted``
    event only where the loss surfaced inside a pull the salvage then took
    (that pull's own ladder ends there, in the reference too)."""
    check(len(deg) == 1 and deg[0]["ladder"] == "cpu" and deg[0]["site"] == want_site,
          f"{label}: degraded events {deg}")
    check(len(exh) <= 1 and all(e["site"] == site != want_site for e in exh),
          f"{label}: exhausted events {exh}")
    return deg[0]


def resumed_on_cpu(run, cfg, src_dir: str, at_iter: int, tmp: str, label: str):
    """The run on the CPU, resumed from the snapshot a salvage took at
    ``at_iter`` (from the initial state where it took none), in a directory
    that holds only that snapshot."""
    import dataclasses
    import shutil

    d = os.path.join(tmp, f"{label}-at-loss")
    os.makedirs(d)
    if at_iter:
        name = f"ckpt_{at_iter:08d}.npz"
        shutil.copy(os.path.join(src_dir, name), os.path.join(d, name))
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write(name)
    res = run(dataclasses.replace(cfg, checkpoint_dir=d), resume=True, device="cpu")
    start = [r["start_iter"] for r in res.metrics.records if r.get("event") == "resume"]
    check(start == ([at_iter] if at_iter else []), f"{label}: the CPU run resumed at {start}")
    return res


def last_segment(metrics) -> dict:
    """The run's last segment record (a ``result_pull`` record follows it)."""
    return next(r for r in reversed(metrics.records) if "iters_per_sec" in r)


def cpu_rate(metrics) -> str:
    """Iterations/s of the segments that ran on the CPU after the salvage's
    own (which holds the salvage's graph build)."""
    rates = [r["iters_per_sec"] for r in metrics.records
             if r.get("backend") == "cpu" and "iters_per_sec" in r][1:]
    return f"{float(np.median(rates)):.2f}" if rates else "none (the salvage ran last)"


def degrade_pagerank_phase(graph, device, reset_counts, counts, card_label: str) -> dict:
    """14a, 14b and 14f: PageRank under a loss at each site (segment float32)
    and at the step for the other impls, checkpoints every 5; then a
    whole-backend loss and a kernel's own fault, which exhaust.  Returns the
    card's launches of these runs."""
    import dataclasses
    import shutil

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import ResilienceExhausted
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as pr_ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    base = PageRankConfig(iterations=ITERS, dangling="redistribute", init="uniform",
                          checkpoint_every=CKPT_EVERY)
    cases = [("segment", "float32", *row) for row in DEGRADE_SITES]
    cases += [(impl, dtype, *DEGRADE_SITES[0]) for impl, dtype in DEGRADE_IMPLS]
    total: dict = {}
    unbroken: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl, dtype, site, at_iter, card_iters in cases:
            label = f"degrade {impl} {dtype} {site}"
            cfg = dataclasses.replace(base, dtype=dtype, spmv_impl=impl)
            if (impl, dtype) not in unbroken:
                t0 = time.perf_counter()
                full = run_pagerank(graph, dataclasses.replace(
                    cfg, checkpoint_dir=os.path.join(tmp, f"{impl}-{dtype}")), device=device)
                unbroken[(impl, dtype)] = (full.ranks, time.perf_counter() - t0)
            want, full_wall = unbroken[(impl, dtype)]
            d = os.path.join(tmp, f"{impl}-{dtype}-{site}")
            resume = at_iter > 0 and card_iters == 0
            if resume:  # a run stopped after the snapshot at at_iter
                run_pagerank(graph, dataclasses.replace(cfg, iterations=at_iter + 1,
                                                        checkpoint_dir=d), device=device)
                shutil.copytree(d, d + "-clean")
                t0 = time.perf_counter()
                run_pagerank(graph, dataclasses.replace(cfg, checkpoint_dir=d + "-clean"),
                             resume=True, device=device)
                full_wall = time.perf_counter() - t0
            reset_counts()
            res, wall, deg, exh = lost_run(lambda: run_pagerank(
                graph, dataclasses.replace(cfg, checkpoint_dir=d), resume=resume,
                device=device), site)
            launched = counts()
            add_counts(total, launched)
            ev = check_one_degrade(label, site, deg, exh, "pagerank_result_pull"
                                   if site == "pagerank_result_pull" else "pagerank_step")
            t0 = time.perf_counter()
            cpu = resumed_on_cpu(lambda c, **kw: run_pagerank(graph, c, **kw), cfg, d,
                                 ev["salvage_iter"], tmp, f"{impl}-{dtype}-{site}")
            cpu_wall = time.perf_counter() - t0
            differ = bits_differ(res.ranks, cpu.ranks)
            # against the card's run, the CPU's steps add in another order:
            # float32 is held to the main path's L1 bar; float64 to the
            # segment kernel's per-call bar against its plain version
            # (SEGMENT_F64_RTOL of a row's sum of |x|, so of the rank mass
            # over all rows), once a step
            err = float(np.abs(res.ranks.astype(np.float64) - want).sum())
            bar = (ITERS * SEGMENT_F64_RTOL * float(np.abs(want).sum()) if dtype == "float64"
                   else 1e-3)
            if dtype == "float64":  # how far each order is from a wider sum
                t0 = time.perf_counter()
                ext = extended_pagerank(graph, ITERS)
                print(f"{label}: max abs from a long double run ({np.finfo(np.longdouble).nmant}"
                      f"-bit mantissa; {time.perf_counter() - t0:.1f} s on the host): the card's "
                      f"{float(np.abs(want - ext).max()):.3g}, the degraded run's "
                      f"{float(np.abs(res.ranks - ext).max()):.3g}; top rank {float(ext.max()):.4g}")
            kernels = {k: launched.get(k, 0) for k in PPR_KERNELS[impl]}
            print(f"{label} ({card_label}): degraded at {ev['site']} salvage_iter "
                  f"{ev['salvage_iter']} rerun_iters {ev['rerun_iters']}, exhausted at "
                  f"{[e['site'] for e in exh]}; {res.iterations} iterations; {differ} of "
                  f"{graph.n_nodes} entries differ from the CPU run resumed from that "
                  f"snapshot ({cpu_wall:.3f} s); L1 vs the unbroken card run {err:.3g} (bar "
                  f"{bar:.3g}; max abs {float(np.abs(res.ranks - want).max()):.3g}); wall "
                  f"{wall:.3f} s against "
                  f"{full_wall:.3f} s unbroken; CPU iterations/s after the hand-over "
                  f"{cpu_rate(res.metrics)}; card launches {launched}")
            check(ev["salvage_iter"] == at_iter and res.iterations == ITERS,
                  f"{label}: salvage_iter {ev['salvage_iter']}, {res.iterations} iterations")
            check(differ == 0, f"{label}: {differ} entries differ from the CPU resume")
            check(err <= bar, f"{label}: L1 {err} from the unbroken card run, bar {bar}")
            check(all(v == card_iters for v in kernels.values())
                  and sum(launched.values()) == card_iters * len(kernels),
                  f"{label}: card launches {launched}, wanted {card_iters} of each of {kernels}")

        # 14b: what the salvage does not take, each at the third segment: a
        # whole-backend loss surfacing at its delta sync (the segment's
        # kernels ran), and a kernel's own fault at its dispatch (none ran)
        cfg = dataclasses.replace(base, dtype="float32", spmv_impl="segment")
        real = pr_ops.make_pagerank_runner
        steps = [0]

        def faulty(n, seg_cfg):
            run = real(n, seg_cfg)

            def step(dg, ranks, e):
                steps[0] += 1
                if steps[0] == 3:
                    raise RuntimeError(KERNEL_FAULT)
                return run(dg, ranks, e)

            return step

        for label, plan, want_launches in (
                ("backend loss", BACKEND_LOSS, 3 * CKPT_EVERY),
                ("kernel fault", None, 2 * CKPT_EVERY)):
            m = MetricsRecorder()
            err = None
            reset_counts()
            with FaultEvents() as ev, (chaos.inject(plan) if plan else
                                       contextlib.nullcontext()):
                if plan is None:
                    pr_ops.make_pagerank_runner = faulty
                try:
                    run_pagerank(graph, dataclasses.replace(
                        cfg, checkpoint_dir=os.path.join(tmp, label)), metrics=m,
                        device=device)
                except ResilienceExhausted as exc:
                    err = exc
                finally:
                    pr_ops.make_pagerank_runner = real
            launched = counts()
            add_counts(total, launched)
            check(err is not None, f"degrade {label}: no ResilienceExhausted")
            latest = os.path.basename(err.last_checkpoint or "")
            on_cpu = [r for r in m.records if "backend" in r]
            print(f"degrade {label} ({plan or KERNEL_FAULT!r}, {card_label}): raised "
                  f"ResilienceExhausted at {err.site!r} ({type(err.last_error).__name__}), "
                  f"last checkpoint {latest}; events degraded {len(ev.of('degraded'))}, "
                  f"exhausted {len(ev.of('exhausted'))}; segments on the CPU {len(on_cpu)}; "
                  f"card launches {launched}")
            check(err.site == "pagerank_step" and latest == f"ckpt_{LOST_CKPT:08d}.npz",
                  f"degrade {label}: exhausted at {err.site}, last checkpoint {latest}")
            check(not ev.of("degraded") and ev.of("exhausted") and not on_cpu
                  and not elastic.health().lost(),
                  f"degrade {label}: a rung took it ({ev.of('degraded')}, {on_cpu})")
            check(launched.get("segment", 0) == want_launches == sum(launched.values()),
                  f"degrade {label}: card launches {launched}, wanted {want_launches}")
    return total


def degrade_workloads_phase(graph, device, reset_counts, counts, card_label: str) -> dict:
    """14c: PPR (segment, B = 8, float32), HITS (tol 1e-8, float32) and
    components under a loss at their delta syncs, and PPR at its result pull:
    one ``degraded`` each; PPR and HITS equal to their ``device="cpu"`` runs
    bit for bit, labels equal to scipy's.  Returns the card's launches."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import ppr
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import (
        run_components,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        HitsConfig,
        PageRankConfig,
    )

    n = graph.n_nodes
    rng = np.random.default_rng(SEED)
    queries = [[int(graph.node_ids[i])] for i in rng.integers(0, n, size=PPR_BATCH)]
    pcfg = PageRankConfig(iterations=PPR_ITERS, dangling="redistribute", init="uniform",
                          spmv_impl="segment")
    hcfg = HitsConfig(iterations=HITS_ITERS, tol=HITS_TOL, dtype="float32")
    k, comp = connected_components(
        csr_matrix((np.ones(graph.n_edges, np.int8), (graph.src, graph.dst)), shape=(n, n)),
        directed=True, connection="weak")
    smallest = np.full(k, n, np.int64)
    np.minimum.at(smallest, comp, np.arange(n))

    def hits_of(res):
        return np.stack([res.hubs, res.authorities])

    runs = {
        "ppr": lambda dev: ppr.run_ppr_batch(graph, pcfg, queries, device=dev).ranks,
        "hits": lambda dev: hits_of(run_hits(graph, hcfg, device=dev)),
        "cc": lambda dev: run_components(graph, device=dev).labels,
    }
    on_cpu = {}
    total: dict = {}
    for site in WORKLOAD_LOSSES:
        workload = site.split("_")[0]
        if workload not in on_cpu:
            t0 = time.perf_counter()
            on_cpu[workload] = (runs[workload]("cpu"), time.perf_counter() - t0)
        want, cpu_wall = on_cpu[workload]
        reset_counts()
        got, wall, deg, exh = lost_run(lambda: runs[workload](device), site)
        launched = counts()
        add_counts(total, launched)
        ev = check_one_degrade(f"degrade {site}", site, deg, exh,
                               site if site.endswith("result_pull") else f"{workload}_step")
        if workload == "cc":
            wrong = int((got != smallest[comp]).sum())
            same = f"{wrong} labels differ from scipy's"
            check(wrong == 0, f"degrade {site}: {same}")
        else:
            differ = bits_differ(got, want)
            same = f"{differ} entries differ from the device='cpu' run"
            check(differ == 0, f"degrade {site}: {same}")
        print(f"degrade {site} ({card_label}): degraded at {ev['site']} salvage_iter "
              f"{ev['salvage_iter']} rerun_iters {ev['rerun_iters']}; {same}; wall {wall:.3f} s "
              f"(device='cpu' run {cpu_wall:.3f} s); card launches {launched}")
        if workload == "ppr":
            check(launched.get("segment", 0) == PPR_BATCH * PPR_ITERS,
                  f"degrade {site}: card launches {launched}")
    return total


def degrade_streaming_phase(device, docs, knobs: dict, chunk_docs: int, card_label: str) -> None:
    """14d: phase 9's config-2 stand-in, pipelined, a checkpoint every
    STREAM_CKPT_EVERY chunks, under a loss at each of STREAM_LOSSES, and
    resumed from a snapshot under a loss at its next commit
    (STREAM_COMMIT_LOSS, so ``salvage_chunk`` and ``rerun_chunks`` are both
    above 0): one ``degraded`` with ``rerun_chunks``; COO, counts and DF
    equal to the card's stream, every output array to a ``device="cpu"``
    stream, bit for bit."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    chunks = chunked(docs, chunk_docs)
    card = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**knobs), device=device)
    t0 = time.perf_counter()
    cpu = tm.run_tfidf_streaming(iter(chunks), tcfg.TfidfConfig(**knobs), device="cpu")
    cpu_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        for site in STREAM_LOSSES:
            cfg = tcfg.TfidfConfig(**knobs, checkpoint_every=STREAM_CKPT_EVERY,
                                   checkpoint_dir=os.path.join(tmp, site))
            out, wall, deg, exh = lost_run(
                lambda: tm.run_tfidf_streaming(iter(chunks), cfg, device=device), site)
            ev = check_one_degrade(f"degrade {site}", site, deg, exh, site)
            check("rerun_chunks" in ev, f"degrade {site}: {ev}")
            for f in ("doc", "term", "count", "df"):
                check(getattr(out, f).tobytes() == getattr(card, f).tobytes(),
                      f"degrade {site}: {f} differs from the card's stream")
            for f in ("doc", "term", "count", "weight", "df", "idf", "doc_lengths"):
                check(getattr(out, f).tobytes() == getattr(cpu, f).tobytes(),
                      f"degrade {site}: {f} differs from the CPU stream")
            print(f"degrade {site} ({card_label}): config-2 stream, {out.nnz} pairs, degraded "
                  f"salvage_chunk {ev['salvage_chunk']} rerun_chunks {ev['rerun_chunks']}; "
                  f"COO, counts and df equal to the card's stream, every array to the CPU "
                  f"stream's; wall {wall:.3f} s (device='cpu' stream {cpu_wall:.3f} s)")

        # a loss after a commit: the rollback truncates the resumed host
        # parts back to the snapshot and replays the retained chunks
        site = STREAM_COMMIT_LOSS
        cfg = tcfg.TfidfConfig(**knobs, checkpoint_every=STREAM_CKPT_EVERY,
                               checkpoint_dir=os.path.join(tmp, "resumed"))
        tm.run_tfidf_streaming(iter(chunks[:2 * len(chunks) // 3]), cfg, device=device)
        start = tm.resume_point(cfg)
        check(start > 0, f"degrade {site}: the first part wrote no checkpoint")
        out, wall, deg, exh = lost_run(lambda: tm.run_tfidf_streaming(
            iter(chunks), cfg, resume=True, device=device), site)
        check(len(deg) == 1 and deg[0]["ladder"] == "cpu"
              and len(exh) <= 1 and all(e["site"] == site for e in exh),
              f"degrade {site}: degraded {deg}, exhausted {exh}")
        ev = deg[0]
        check(ev["salvage_chunk"] >= start > 0 and ev["rerun_chunks"] > 0,
              f"degrade {site}: nothing committed before the loss: {ev}")
        for f in ("doc", "term", "count", "df"):
            check(getattr(out, f).tobytes() == getattr(card, f).tobytes(),
                  f"degrade {site}: {f} differs from the card's stream")
        for f in ("doc", "term", "count", "weight", "df", "idf", "doc_lengths"):
            check(getattr(out, f).tobytes() == getattr(cpu, f).tobytes(),
                  f"degrade {site}: {f} differs from the CPU stream")
        print(f"degrade {site} ({card_label}): config-2 stream resumed from its snapshot at "
              f"chunk {start}, {out.nnz} pairs, degraded at "
              f"{ev['site']} salvage_chunk {ev['salvage_chunk']} rerun_chunks "
              f"{ev['rerun_chunks']} (exhausted at {[e['site'] for e in exh]}); COO, counts "
              f"and df equal to the card's stream, every array to the CPU stream's; wall "
              f"{wall:.3f} s")


def degrade_phase(graph, stream: dict, reset_counts, counts, card_label: str) -> dict:
    """Phase 14 (see the module docstring); every check raises on failure.
    Returns the launches of its counted runs, for the kernels line."""
    total: dict = {}
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    add_counts(total, degrade_pagerank_phase(graph, dev, reset_counts, counts, card_label))
    print(f"phase 14a-b (pagerank): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add_counts(total, degrade_workloads_phase(graph, dev, reset_counts, counts, card_label))
    print(f"phase 14c (workloads): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    degrade_streaming_phase(dev, stream["docs"], stream["knobs"], stream["chunk_docs"],
                            card_label)
    print(f"phase 14d (streaming): {time.perf_counter() - t0:.1f} s")
    return total


# Phase 15: tuned profiles (utils/config.py's ladder, tools/autotune.py).
# The tuner's declared knob domain drives kernels at shapes no earlier phase
# holds: rowsum over the hybrid head at head_row_width 64, 128 and 256 and
# head_coverage 0.25, 0.5 and 0.75 (each layout built once, for both dtypes
# and both runs), the hybrid tail's cumsum and head's segment sum there, and
# sort_shuffle's bucket loader at widths 4, 8 and 16 (15b).  15c sweeps twice
# on the tuner's probes, 15d drives the PageRank CLI's ladder at full size,
# 15e runs defaults against the committed profile at full size in turns.
TUNE_PLAN = {"hybrid": (9, 0), "owned": (3, 0), "shuffle": (3, 0), "ingest": (9, 36),
             "serve": (18, 9)}  # survivors / pruned by group, as on the CPU
TUNE_KERNELS = {"hybrid": ("rowsum", "cumsum", "segment"), "sort_shuffle": ("segment",)}
TUNE_BUDGET_S = 20
TUNE_AB_ORDER = "DPPDPD"  # D: TUNABLE_DEFAULTS, P: the committed profile
TUNE_AB_QUERIES = 1024


def loop_ranks(graph, cfg, dg) -> np.ndarray:
    """``cfg``'s iteration loop on a prebuilt device graph, pulled."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops

    n = graph.n_nodes
    e = torch.from_numpy(ops.restart_vector(n, cfg)).to("cuda")
    r0 = torch.from_numpy(ops.init_ranks(n, cfg)).to("cuda")
    ranks, _, _ = ops.make_pagerank_runner(n, cfg)(dg, r0, e)
    return ranks.cpu().numpy()


def tuned_plan_phase(autotune) -> None:
    """15a: the tuner's ``--dry-run`` on the card: the CPU's plan."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = autotune.main(["--dry-run", "--json"])
    doc = json.loads(out.getvalue())
    plan = doc["plan"]
    groups = {g: (len(v["survivors"]), len(v["pruned"])) for g, v in plan["groups"].items()}
    check(rc == 0 and doc["backend"] == "gpu" and plan["raw_points"] == 87
          and plan["pruned_points"] == 45 and groups == TUNE_PLAN,
          f"autotune --dry-run: rc {rc}, backend {doc['backend']}, {plan['raw_points']} raw, "
          f"{plan['pruned_points']} pruned, {groups}")
    print(f"15a autotune --dry-run: backend {doc['backend']}, {plan['raw_points']} raw points, "
          f"{plan['pruned_points']} pruned, survivors/pruned by group {groups}")


def tuned_kernels_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """15b: at every point of the declared domain's layouts, each kernel of
    the layout against its plain version on the main path's uniform ranks,
    and the 20-iteration loop twice per dtype: bit-equal, within L1 1e-3 of
    ``segment`` in float32 and L1 1e-12 in float64, launching each of its
    kernels once a step.  Returns the counted runs' launches."""
    import dataclasses

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import put_graph_for
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import autotune
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    domains = autotune._knob_domains()
    n = graph.n_nodes
    base = PageRankConfig(iterations=ITERS, dangling="redistribute", init="uniform")
    seg, per_dtype = {}, {}
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(base, dtype=dtype)
        dg = put_graph_for(graph, cfg, "cuda")
        seg[dtype] = loop_ranks(graph, cfg, dg)
        per_dtype[dtype] = {f: getattr(dg, f) for f in ("inv_outdeg", "dangling", "has_outlinks")}
    total: dict = {}
    worst: dict = {}

    def note(key, value) -> None:
        worst[key] = max(worst.get(key, 0.0), value)

    def loops(label, impl, cfg32, dg32) -> str:
        """Both dtypes' loops on one layout: two runs bit-equal, each kernel
        of the impl ITERS times in the counted one, close to segment."""
        parts = []
        for dtype in ("float32", "float64"):
            cfg = dataclasses.replace(cfg32, dtype=dtype)
            dg = dg32._replace(**per_dtype[dtype])
            reset_counts()
            a = loop_ranks(graph, cfg, dg)
            launched = counts()
            b = loop_ranks(graph, cfg, dg)
            add_counts(total, launched)
            check(a.tobytes() == b.tobytes(), f"15b {label} {dtype}: two runs differ")
            want = {k: ITERS for k in TUNE_KERNELS[impl]}
            check({k: v for k, v in launched.items() if v} == want,
                  f"15b {label} {dtype}: launched {launched}, wanted {want}")
            diff = np.abs(a.astype(np.float64) - seg[dtype])
            l1, mx = float(diff.sum()), float(diff.max())
            check(bool(np.isfinite(a).all()) and l1 <= (1e-3 if dtype == "float32" else 1e-12),
                  f"15b {label} {dtype}: L1 {l1:.3g}, max abs {mx:.3g} vs segment")
            note(("loop L1", dtype), l1)
            note(("loop max abs", dtype), mx)
            parts.append(f"{dtype} L1 {l1:.3g} max abs {mx:.3g}")
        return "; ".join(parts)

    for cov in domains["head_coverage"]:
        for width in domains["head_row_width"]:
            label = f"hybrid head_coverage {cov} head_row_width {width}"
            cfg32 = dataclasses.replace(base, spmv_impl="hybrid", head_coverage=cov,
                                        head_row_width=width)
            t0 = time.perf_counter()
            dg32 = put_graph_for(graph, cfg32, "cuda")
            build = time.perf_counter() - t0
            hl = dg32.hybrid
            h = hl.head_ids.shape[0]
            times = []
            for dtype in ("float32", "float64"):
                weighted = per_dtype[dtype]["inv_outdeg"] / n  # uniform ranks
                rows = torch.cat([weighted, weighted.new_zeros(1)])[hl.head_src]
                tail = weighted[hl.tail_src]
                r = measure_rowsum(pk, rows, f"15b {label} R={rows.shape[0]} W={rows.shape[1]} "
                                             f"{dtype}")
                c = measure_cumsum(pk, tail, f"15b {label} tail E={tail.shape[0]} {dtype}")
                sums = pk.rowsum_kernel(rows)
                err, _ = check_segment(sk, sums, hl.head_row_ptr, h, f"15b {label} head {dtype}",
                                       plan=hl.head_row_plan)
                s_ms = time_ms(lambda: sk.segment_sum_kernel(sums, hl.head_row_ptr, h,
                                                             plan=hl.head_row_plan))
                s_plain = time_ms(lambda: sk.segment_sum_plain(sums, hl.head_row_ptr, h))
                note(("rowsum", dtype), r["max_abs_err"])
                note(("cumsum", dtype), c["max_abs_err"])
                note(("segment", dtype), err)
                times.append(f"{dtype} rowsum {r['ms']:.4f} (plain {r['plain_ms']:.4f}), cumsum "
                             f"{c['ms']:.4f} ({c['plain_ms']:.4f}), segment {s_ms:.4f} "
                             f"({s_plain:.4f})")
            held = loops(label, "hybrid", cfg32, dg32)
            print(f"15b {label}: head {h} nodes, {hl.head_src.shape[0]} rows x "
                  f"{hl.head_src.shape[1]}, tail {hl.tail_src.shape[0]} edges (layout "
                  f"{build:.2f} s); kernel ms (plain ms): {'; '.join(times)}; 20 iterations "
                  f"twice, equal bits, vs segment: {held} on {card_label}")
    for width in domains["shuffle_bucket_width"]:
        label = f"sort_shuffle bucket width {width}"
        cfg32 = dataclasses.replace(base, spmv_impl="sort_shuffle", shuffle_bucket_width=width)
        t0 = time.perf_counter()
        dg32 = put_graph_for(graph, cfg32, "cuda")
        build = time.perf_counter() - t0
        sl = dg32.shuffle
        times = []
        for dtype in ("float32", "float64"):
            weighted = per_dtype[dtype]["inv_outdeg"] / n
            vals = torch.cat([weighted, weighted.new_zeros(1)])[sl.bucket_src].sum(dim=1)
            err, _ = check_segment(sk, vals, sl.bucket_ptr, n, f"15b {label} {dtype}",
                                   plan=sl.bucket_plan)
            k_ms = time_ms(lambda: sk.segment_sum_kernel(vals, sl.bucket_ptr, n,
                                                         plan=sl.bucket_plan))
            p_ms = time_ms(lambda: sk.segment_sum_plain(vals, sl.bucket_ptr, n))
            note(("segment", dtype), err)
            times.append(f"{dtype} segment {k_ms:.4f} (plain {p_ms:.4f}), max abs diff {err:.3g}")
        held = loops(label, "sort_shuffle", cfg32, dg32)
        print(f"15b {label}: {sl.bucket_src.shape[0]} buckets x {sl.bucket_src.shape[1]} "
              f"(layout {build:.2f} s); kernel ms (plain ms): {'; '.join(times)}; 20 iterations "
              f"twice, equal bits, vs segment: {held} on {card_label}")
    print("15b worst differences: " + ", ".join(f"{k} {d} {v:.3g}"
                                                for (k, d), v in sorted(worst.items())))
    return total


def check_confirm_rule(autotune, tcfg, prof, label: str) -> None:
    """A profile's groups obey the tuner's rule: a group the budget left
    unmeasured (a fallback) at its default; every other group measured its
    TUNABLE_DEFAULTS point first, and left it only for a winner each of
    whose CONFIRM_ORDER runs beat each run of the defaults."""
    for group, v in prof.measured["groups"].items():
        default = {k: tcfg.TUNABLE_DEFAULTS[k] for k in dict(autotune.GROUPS)[group]}
        check({k: prof.knobs[k] for k in default} == v["winner"],
              f"{label}: {group}'s knobs are not its winner {v['winner']}")
        if v["fallback"]:
            check(v["winner"] == default, f"{label}: {group} {v}")
            continue
        first = v["measured"][0] if v["measured"] else {}
        check(first.get("point") == default and first.get("default") and "secs" in first,
              f"{label}: {group} did not measure its defaults first ({first})")
        c = v.get("confirm")
        check(v["winner"] == default
              or (c is not None and c["kept"] == "winner"
                  and len(c["winner"]) + len(c["default"]) == len(autotune.CONFIRM_ORDER)
                  and max(c["winner"]) < min(c["default"])),
              f"{label}: {group} left its defaults for {v['winner']} without beating them "
              f"({c})")


def tuned_sweep_phase(autotune, tcfg, smi: dict, tmp: str) -> tuple:
    """15c: two sweeps on the tuner's probes into temporary paths: every
    tuned knob in its domain, stamped ``gpu`` with the card's name and
    power limit, each group under the tuner's rule (``owned`` measured on
    four slots of the card when the budget reaches it).  Returns the first
    sweep's path and profile."""
    import io

    domains = autotune._knob_domains()
    swept = []
    for i in (1, 2):
        path = os.path.join(tmp, f"sweep{i}.json")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = autotune.main(["--out", path, "--budget-s", str(TUNE_BUDGET_S), "--json"])
        secs = time.perf_counter() - t0
        check(rc == 0, f"15c sweep {i} exited {rc}")
        prof = tcfg.load_tuned_profile(backend="gpu", path=path)
        m = prof.measured
        check(set(prof.knobs) == set(domains)
              and all(prof.knobs[k] in domains[k] for k in domains),
              f"15c sweep {i}: knobs {prof.knobs}")
        check(prof.backend == "gpu" and m["device"] == smi["device"]
              and m["power_limit"] == smi["power_limit"],
              f"15c sweep {i}: stamped {prof.backend}, {m['device']}, {m['power_limit']}")
        check_confirm_rule(autotune, tcfg, prof, f"15c sweep {i}")
        print(f"15c sweep {i} ({secs:.1f} s, sweep_secs {m['sweep_secs']}, budget "
              f"{TUNE_BUDGET_S} s, {m['device']}, {m['power_limit']}): "
              + "; ".join(f"{g} {v['winner']} {v['winner_secs']} s"
                          f"{' fallback' if v['fallback'] else ''} "
                          f"({sum('secs' in x for x in v['measured'])} measured"
                          + (f", defaults {v['measured'][0]['secs']} s" if v["measured"] else "")
                          + (f", {v['confirm']['order']} W {v['confirm']['winner']} D "
                             f"{v['confirm']['default']} kept {v['confirm']['kept']}"
                             if "confirm" in v else "") + ")"
                          for g, v in m["groups"].items()))
        swept.append((path, prof))
    agree = [g for g in swept[0][1].measured["groups"]
             if swept[0][1].measured["groups"][g]["winner"]
             == swept[1][1].measured["groups"][g]["winner"]]
    print(f"15c: the two sweeps pick the same winner in {agree}, differ in "
          f"{[g for g in swept[0][1].measured['groups'] if g not in agree]}")
    return swept[0]


def profile_snapshot(prof, source: str) -> dict:
    """The manifest's ``tuned_profile`` for ``prof`` resolved by ``source``."""
    return {"path": str(prof.path), "backend": prof.backend, "git_sha": prof.git_sha,
            "source": source, "knobs": prof.knobs}


def tuned_ladder_phase(graph, default_ranks, path: str, prof, committed, reset_counts, counts,
                       tmp: str) -> None:
    """15d: the PageRank CLI (``hybrid``, float32, full size) through each
    rung of the ladder: its ranks bit-equal to ``run_pagerank`` with
    ``tuned_config`` over the same profile (the committed one with no flag
    and no env, the defaults' for ``off``), its output file byte-equal to
    ``save_ranks`` of them, its manifest naming the profile; a ``cpu``
    profile on the card and the ``gpu`` profile under ``--device cpu``
    raise ``ProvenanceError`` and run nothing."""
    import glob

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as cli
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import save_ranks
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.artifacts import ProvenanceError

    base = dict(iterations=ITERS, dangling="redistribute", init="uniform", spmv_impl="hybrid")
    argv = [f"synthetic:{N_NODES},{N_EDGES},{SEED}", str(ITERS), "--spmv-impl", "hybrid",
            "--dangling", "redistribute", "--init", "uniform"]
    other = 64 if prof.knobs["head_row_width"] != 64 else 256
    api = {
        "profile": run_pagerank(graph, tcfg.tuned_config(tcfg.PageRankConfig, prof, **base),
                                device="cuda").ranks,
        "explicit": run_pagerank(graph, tcfg.tuned_config(tcfg.PageRankConfig, prof,
                                                          head_row_width=other, **base),
                                 device="cuda").ranks,
        "committed": run_pagerank(graph, tcfg.tuned_config(tcfg.PageRankConfig, committed,
                                                           **base), device="cuda").ranks,
        "defaults": default_ranks,
    }
    rungs = (  # name, CLI flags, GRAFT_TUNED_PROFILE, API ranks, manifest snapshot
        ("--tuned-profile", ["--tuned-profile", path], None, "profile",
         profile_snapshot(prof, "explicit")),
        ("--head-row-width beats it", ["--tuned-profile", path, "--head-row-width", str(other)],
         None, "explicit", profile_snapshot(prof, "explicit")),
        ("GRAFT_TUNED_PROFILE", [], path, "profile", profile_snapshot(prof, "env")),
        ("off beats GRAFT_TUNED_PROFILE", ["--tuned-profile", "off"], path, "defaults", None),
        ("no flag, no env: the committed profile", [], None, "committed",
         profile_snapshot(committed, "committed")),
    )
    seen = []
    real = cli.run_pagerank

    def spy(g, cfg, **kw):
        res = real(g, cfg, **kw)
        seen.append((cfg, res.ranks))
        return res

    cli.run_pagerank = spy
    try:
        for i, (name, flags, env, want, want_snap) in enumerate(rungs):
            d = os.path.join(tmp, f"ladder{i}")
            out = os.path.join(d, "ranks.tsv")
            if env is not None:
                os.environ["GRAFT_TUNED_PROFILE"] = env
            try:
                rc = cli.main([*argv, *flags, "--output", out, "--trace-dir", d])
            finally:
                os.environ.pop("GRAFT_TUNED_PROFILE", None)
            check(rc == 0, f"15d {name}: CLI exited {rc}")
            cfg, ranks = seen[-1]
            check(ranks.tobytes() == api[want].tobytes(),
                  f"15d {name}: the CLI's ranks differ from the API's ({want})")
            save_ranks(os.path.join(d, "api.tsv"), graph, api[want])
            with open(out, "rb") as f, open(os.path.join(d, "api.tsv"), "rb") as g:
                check(f.read() == g.read(), f"15d {name}: the output file differs from the API's")
            (man,) = glob.glob(os.path.join(d, "pagerank.*.manifest.json"))
            with open(man) as f:
                got_snap = json.load(f)["tuned_profile"]
            check(got_snap == want_snap, f"15d {name}: manifest tuned_profile {got_snap}")
            print(f"15d {name}: head_coverage {cfg.head_coverage}, head_row_width "
                  f"{cfg.head_row_width}, shuffle_bucket_width {cfg.shuffle_bucket_width}; ranks "
                  f"equal to run_pagerank's ({want}) bit for bit, the file byte for byte; "
                  f"manifest source {None if got_snap is None else got_snap['source']}")
        cpu_path = os.path.join(tmp, "cpu_profile.json")
        tcfg.write_tuned_profile(cpu_path, "cpu", prof.knobs)
        for name, flags in (("a cpu profile on the card", ["--tuned-profile", cpu_path]),
                            ("the gpu profile under --device cpu",
                             ["--tuned-profile", path, "--device", "cpu"])):
            reset_counts()
            ran = len(seen)
            try:
                cli.main([*argv, *flags])
                raised = None
            except ProvenanceError as exc:
                raised = exc
            check(raised is not None and len(seen) == ran and not any(counts().values()),
                  f"15d {name}: raised {raised!r}, ran {len(seen) - ran}, launched {counts()}")
            print(f"15d {name}: ProvenanceError, nothing run ({str(raised)[:90]}...)")
    finally:
        cli.run_pagerank = real


def tuned_cli_phase(docs, committed, out, index, tmp: str) -> None:
    """15d, the other CLIs under the committed profile (no flag, no env):
    the streaming TF-IDF CLI killed after chunk KILL_AFTER with a
    checkpoint every KILL_EVERY and resumed, its tuned knobs those of
    ``tuned_config(TfidfConfig, committed)`` and its sorted COO, counts,
    weights, DF and IDF equal to batch's bit for bit, as are those of
    ``run_tfidf_streaming`` over that config; the serve CLI (impacted) on
    the config-2 index, its knobs those of ``tuned_config(ServeConfig,
    committed)`` and its lines a server's over that config.  Each manifest
    names the committed profile."""
    import dataclasses
    import glob
    import io

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import serve as cli_serve
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import tfidf as cli_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    want_snap = profile_snapshot(committed, "committed")

    def knobs_of(cfg) -> dict:
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if f.name in tcfg.TUNABLE_DEFAULTS}

    def manifest_of(d: str, name: str) -> dict:
        (path,) = glob.glob(os.path.join(d, f"{name}.*.manifest.json"))
        with open(path) as f:
            return json.load(f)

    corpus = os.path.join(tmp, "corpus.txt")
    with open(corpus, "w") as f:
        f.writelines(d + "\n" for d in docs)
    ck, trace_dir = os.path.join(tmp, "tfidf_ck"), os.path.join(tmp, "tfidf_trace")
    argv = [corpus, "--lines", "--streaming", "--vocab-bits", str(TFIDF_BITS), "--chunk-docs",
            str(STREAM_CHUNK_DOCS), "--checkpoint-dir", ck, "--checkpoint-every",
            str(KILL_EVERY), "--trace-dir", trace_dir]
    real_chunks, real_stream, seen = cli_tfidf.iter_corpus_chunks, cli_tfidf.run_tfidf_streaming, []

    def killed(*args, **kwargs):
        for i, chunk in enumerate(real_chunks(*args, **kwargs)):
            if i == KILL_AFTER:
                raise Killed(f"killed after chunk {KILL_AFTER}")
            yield chunk

    def spy(chunks, cfg, **kwargs):
        res = real_stream(chunks, cfg, **kwargs)
        seen.append((cfg, res))
        return res

    cli_tfidf.run_tfidf_streaming = spy
    try:
        cli_tfidf.iter_corpus_chunks = killed
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                cli_tfidf.main(argv)
            raised = None
        except Killed as exc:
            raised = exc
        cli_tfidf.iter_corpus_chunks = real_chunks
        check(raised is not None and not seen, f"15d tfidf CLI: not killed ({raised!r})")
        check(manifest_of(trace_dir, "tfidf")["tuned_profile"] == want_snap,
              "15d tfidf CLI (killed): manifest tuned_profile")
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli_tfidf.main([*argv, "--resume"])
    finally:
        cli_tfidf.iter_corpus_chunks, cli_tfidf.run_tfidf_streaming = real_chunks, real_stream
    check(rc == 0 and len(seen) == 1, f"15d tfidf CLI --resume: exited {rc}")
    cfg, res = seen[0]
    tuned = tcfg.tuned_config(tcfg.TfidfConfig, committed, vocab_bits=TFIDF_BITS)
    check(knobs_of(cfg) == knobs_of(tuned),
          f"15d tfidf CLI: knobs {knobs_of(cfg)}, tuned_config's {knobs_of(tuned)}")
    check_same_coo(res, out, "15d tfidf CLI (killed and resumed)")
    check_same_coo(tm.run_tfidf_streaming(iter(chunked(docs, STREAM_CHUNK_DOCS)), tuned,
                                          device="cuda"),
                   out, "15d run_tfidf_streaming over tuned_config(committed)")
    man = manifest_of(trace_dir, "tfidf")
    check(man["tuned_profile"] == want_snap and man["status"] == "ok",
          f"15d tfidf CLI: manifest {man['status']} {man['tuned_profile']}")
    print(f"15d the tfidf CLI under the committed profile: killed after chunk {KILL_AFTER} "
          f"(checkpoint every {KILL_EVERY}) and resumed; knobs {knobs_of(cfg)}; COO, counts, "
          f"weights, DF and IDF equal to batch bit for bit, as are run_tfidf_streaming's over "
          f"tuned_config; manifest source committed")

    qs = serving_queries(docs, SERVE_QUERIES, SERVE_SEED)[:CLI_QUERIES]
    scfg = tcfg.tuned_config(serving.ServeConfig, committed, scoring="impacted")
    want = []
    with serving.TfidfServer(index, scfg, device="cuda") as srv:
        for qid, q in enumerate(qs):
            s, d = srv.query(q)
            want += [f"{qid}\t{int(i)}\t{float(v):.10g}" for v, i in zip(s, d) if v > 0]
    qfile, trace_dir = os.path.join(tmp, "queries.txt"), os.path.join(tmp, "serve_trace")
    with open(qfile, "w") as f:
        f.writelines(" ".join(q) + "\n" for q in qs)
    real_server, served = cli_serve.TfidfServer, []

    def server_spy(idx, c, **kwargs):
        served.append(c)
        return real_server(idx, c, **kwargs)

    cli_serve.TfidfServer = server_spy
    try:
        lines = io.StringIO()
        with contextlib.redirect_stdout(lines), contextlib.redirect_stderr(io.StringIO()):
            rc = cli_serve.main([os.path.dirname(index.path), "--queries", qfile, "--scoring",
                                 "impacted", "--trace-dir", trace_dir])
    finally:
        cli_serve.TfidfServer = real_server
    check(rc == 0 and len(served) == 1, f"15d serve CLI exited {rc}")
    check(knobs_of(served[0]) == knobs_of(scfg),
          f"15d serve CLI: knobs {knobs_of(served[0])}, tuned_config's {knobs_of(scfg)}")
    check(lines.getvalue().splitlines() == want,
          "15d serve CLI: lines differ from a server over tuned_config(committed)")
    man = manifest_of(trace_dir, "serve")
    check(man["tuned_profile"] == want_snap and man["status"] == "ok",
          f"15d serve CLI: manifest {man['status']} {man['tuned_profile']}")
    print(f"15d the serve CLI under the committed profile (impacted, {len(qs)} queries): knobs "
          f"{knobs_of(served[0])}; {len(want)} lines equal to a server's over tuned_config; "
          f"manifest source committed")


def spread(d: list, p: list) -> str:
    """Medians and spreads of two sides; a side is ahead only when its
    spread lies wholly beyond the other's."""
    verdict = ("profile ahead" if min(p) > max(d) else "defaults ahead" if min(d) > max(p)
               else "unresolved")
    return (f"defaults median {np.median(d):.6g} ({min(d):.6g}-{max(d):.6g}), profile median "
            f"{np.median(p):.6g} ({min(p):.6g}-{max(p):.6g}): {verdict}")


def tuned_ab_phase(graph, docs, prof, out, index, card_label: str) -> None:
    """15e: TUNABLE_DEFAULTS (D) against the committed profile (P) in turns
    (TUNE_AB_ORDER), at full size: config 1 ``hybrid`` iterations/s, the
    config-2 stream's tokens/s (every run's sorted COO, weights, DF and IDF
    equal to batch's bit for bit) and
    11b's server (impacted, four closed-loop clients) over TUNE_AB_QUERIES
    queries.  Not a claim: medians and spreads."""
    import dataclasses

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    tuned = tcfg.tuned_config
    pr = dict(iterations=ITERS, dangling="redistribute", init="uniform", spmv_impl="hybrid")
    queries = serving_queries(docs, SERVE_QUERIES, SERVE_SEED)[:TUNE_AB_QUERIES]
    sv = dict(scoring="impacted", cache_size=2 * len(queries))
    cfgs = {
        "pagerank": {"D": tcfg.PageRankConfig(**pr), "P": tuned(tcfg.PageRankConfig, prof, **pr)},
        "stream": {"D": tcfg.TfidfConfig(vocab_bits=TFIDF_BITS),
                   "P": tuned(tcfg.TfidfConfig, prof, vocab_bits=TFIDF_BITS)},
        "serve": {"D": serving.ServeConfig(**sv), "P": tuned(serving.ServeConfig, prof, **sv)},
    }
    for name, c in cfgs.items():
        knobs = sorted(set(tcfg.TUNABLE_DEFAULTS) & {f.name for f in dataclasses.fields(c["D"])})
        print(f"15e {name} knobs, defaults -> profile: "
              + ", ".join(f"{k} {getattr(c['D'], k)} -> {getattr(c['P'], k)}" for k in knobs))
    chunks = chunked(docs, STREAM_CHUNK_DOCS)
    rates = {name: {"D": [], "P": []} for name in cfgs}
    for side in TUNE_AB_ORDER:
        res = run_pagerank(graph, cfgs["pagerank"][side], device="cuda")
        rates["pagerank"][side].append(last_segment(res.metrics)["iters_per_sec"])
        t0 = time.perf_counter()
        s = tm.run_tfidf_streaming(iter(chunks), cfgs["stream"][side], device="cuda")
        secs = time.perf_counter() - t0
        rates["stream"][side].append(float(s.doc_lengths.sum()) / secs)
        check_same_coo(s, out, f"15e stream {side}")
        with serving.TfidfServer(index, cfgs["serve"][side], device="cuda") as srv:
            r = closed_loop(srv, queries, 4)
        rates["serve"][side].append(len(queries) / r["secs"])
    for name, unit in (("pagerank", "config 1 hybrid iterations/s"),
                       ("stream", "config-2 stream tokens/s"),
                       ("serve", f"impacted queries/s, 4 clients, {len(queries)} queries")):
        d, p = rates[name]["D"], rates[name]["P"]
        print(f"15e {unit} ({TUNE_AB_ORDER}, {card_label}): D "
              + " ".join(f"{x:.6g}" for x in d) + "; P " + " ".join(f"{x:.6g}" for x in p)
              + f"; {spread(d, p)}")


def tuned_phase(graph, docs, default_ranks, smi: dict, reset_counts, counts,
                card_label: str) -> dict:
    """Phase 15 (see the module docstring); every check raises on failure.
    Returns 15b's launches, for the kernels line."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import autotune
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    check(os.environ.get("GRAFT_TUNED_PROFILE") is None,
          "phase 15 needs GRAFT_TUNED_PROFILE unset")
    committed = tcfg.load_tuned_profile(backend="gpu")
    check(committed is not None and committed.source == "committed",
          f"no committed {tcfg.profile_path('gpu')}")
    check_confirm_rule(autotune, tcfg, committed, "the committed profile")
    t0 = time.perf_counter()
    tuned_plan_phase(autotune)
    print(f"phase 15a (plan): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launched = tuned_kernels_phase(graph, reset_counts, counts, card_label)
    print(f"phase 15b (kernels over the domain): {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path, prof = tuned_sweep_phase(autotune, tcfg, smi, tmp)
        print(f"phase 15c (two sweeps): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bits = tcfg.TfidfConfig(vocab_bits=TFIDF_BITS)
        out = tm.run_tfidf(docs, bits, device="cuda")
        serving.save_index(os.path.join(tmp, "index"), out, bits)
        index = serving.load_index(os.path.join(tmp, "index"))
        tuned_ladder_phase(graph, default_ranks, path, prof, committed, reset_counts, counts, tmp)
        tuned_cli_phase(docs, committed, out, index, tmp)
        print(f"phase 15d (ladder): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tuned_ab_phase(graph, docs, committed, out, index, card_label)
        print(f"phase 15e (defaults against the profile): {time.perf_counter() - t0:.1f} s")
    return launched


# ---------------------------------------------------------------- phase 16

SHARD_SLOTS = 4
SHARD_STRATEGIES = ("edges", "nodes", "nodes_balanced", "src", "src_ring", "hybrid", "owned")
# the elastic plan: slot 1 lost at the step, slot 2 at the rerun (4 -> 2 -> 1)
SHRINK_PLAN = "pagerank_step:device_lost@dev:1;pagerank_elastic_rerun:device_lost@dev:2"
SHRINK_LADDER = [("mesh_shrink", 4, 2), ("single_device", 2, 1)]


# Phase 16's slots: ``d`` slots of cuda:0 (the default: the D-shard layout on
# the one card), or one slot a card under ``--cards`` (cards_main).
SLOT_DEVICES: list = ["cuda:0"] * SHARD_SLOTS


def card_mesh(d: int, axis: str | None = None):
    """A mesh of the first ``d`` of phase 16's slot devices."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import mesh as pmesh

    return pmesh.make_mesh(d, axis or pmesh.NODES_AXIS, devices=SLOT_DEVICES[:d])


def collectives_phase() -> None:
    """16a: each collective on 1, 2 and 4 slots (of cuda:0) against the same
    collective over CPU tensors: gathers and permutes exact; float64
    ring_reduce_scatter against reduce_scatter, and psum against a float64
    sum, within 1e-12."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import collectives as coll

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for d in (1, 2, 4):
        x = rng.standard_normal((d, d * 1024))
        cards = [torch.from_numpy(x[i]).to(SLOT_DEVICES[i]) for i in range(d)]
        cpus = [torch.from_numpy(x[i]) for i in range(d)]
        for name in ("all_gather", "ppermute_ring", "butterfly_all_gather", "pmax"):
            got = [t.cpu().numpy() for t in getattr(coll, name)(cards)]
            want = [t.numpy() for t in getattr(coll, name)(cpus)]
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"16a {name} d={d}: the card differs from the CPU")
        rs = np.stack([t.cpu().numpy() for t in coll.reduce_scatter(cards)])
        ring = np.stack([t.cpu().numpy() for t in coll.ring_reduce_scatter(cards)])
        ps = coll.psum(cards)[d - 1].cpu().numpy()
        exact = x.sum(axis=0, dtype=np.float64)
        err = max(float(np.abs(ring - rs).max()), float(np.abs(ps - exact).max()),
                  float(np.abs(rs.ravel() - exact).max()))
        worst = max(worst, err)
        check(err <= 1e-12, f"16a d={d}: reduce error {err:.3g} > 1e-12")
    print(f"16a collectives on 1, 2, 4 slots of {sorted(set(SLOT_DEVICES))}: gathers and "
          f"permutes equal to the CPU's, reductions within {worst:.3g} of float64")


def sharded_run(graph, cfg, strategy: str, d: int, reset_counts, counts):
    """One run_pagerank_sharded on ``d`` slots of the card, its launches
    counted from a reset just before it."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import run_pagerank_sharded

    mesh = card_mesh(d)
    reset_counts()
    res = run_pagerank_sharded(graph, cfg, mesh=mesh, strategy=strategy)
    return res, counts()


# The strategies whose fixed-count float32 runs under segment have one
# device's bits at every slot count (their split sums in float64, rounded
# once); the others add whole float32 partial vectors across the slots.
ONE_DEVICE_BITS = ("owned", "nodes", "nodes_balanced")


def sharded_pagerank_phase(graph, reset_counts, counts, card_label: str,
                           kept: dict) -> dict:
    """16b: every strategy at 4 slots under segment (owned also at 2), and
    cumsum under edges and nodes: float64 within 1e-9 L1 of the
    single-device float64 run, float32 within L1 1e-3 of float64, two
    float32 runs equal bit for bit, float32 ``owned``, ``nodes`` and
    ``nodes_balanced`` under segment equal bit for bit to the one-device
    float32 segment run (the other runs' differing entries printed), the
    launches (segment >= D x 20, rowsum >= 20 under hybrid, cumsum >= D x
    20 under cumsum), iterations/s, partition and put seconds.  Returns the
    launches of the float32 runs; ``kept[(strategy, d, impl, dtype)]`` gets
    each run's ranks and iterations/s, which 16g holds the mesh across
    processes to, and ``kept["one device", "float32"]`` the one-device
    float32 ranks."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    base = dict(iterations=ITERS, dangling="redistribute", init="uniform")
    ref = run_pagerank(graph, PageRankConfig(**base, dtype="float64"), device="cuda").ranks
    one32 = run_pagerank(graph, PageRankConfig(**base, dtype="float32"), device="cuda").ranks
    kept["one device", "float32"] = one32
    runs = ([(s, SHARD_SLOTS, "segment") for s in SHARD_STRATEGIES]
            + [("owned", 2, "segment"), ("edges", SHARD_SLOTS, "cumsum"),
               ("nodes", SHARD_SLOTS, "cumsum")])
    total: dict = {}
    for strategy, d, impl in runs:
        label = f"16b {strategy} D={d} {impl}"
        r64, _ = sharded_run(graph, PageRankConfig(**base, dtype="float64", spmv_impl=impl),
                             strategy, d, reset_counts, counts)
        cfg32 = PageRankConfig(**base, dtype="float32", spmv_impl=impl)
        r32, launched = sharded_run(graph, cfg32, strategy, d, reset_counts, counts)
        again, _ = sharded_run(graph, cfg32, strategy, d, reset_counts, counts)
        add_counts(total, launched)
        kept[(strategy, d, impl, "float32")] = (r32.ranks, r32.metrics.records[-1]["iters_per_sec"])
        kept[(strategy, d, impl, "float64")] = (r64.ranks, r64.metrics.records[-1]["iters_per_sec"])
        l1_64 = float(np.abs(r64.ranks - ref).sum())
        l1_32 = float(np.abs(r32.ranks.astype(np.float64) - ref).sum())
        differ = bits_differ(r32.ranks, again.ranks)
        from_one = bits_differ(r32.ranks, one32)
        part = next(r for r in r32.metrics.records if r.get("event") == "partition")
        rate = r32.metrics.records[-1]["iters_per_sec"]
        where = (f"{d} cards" if len(set(SLOT_DEVICES[:d])) == d
                 else f"{d} slots of one card, not multi-GPU scaling")
        print(f"{label} ({card_label}; {where}): "
              f"{rate:.2f} iterations/s, partition {part['secs']:.3f} s, put "
              f"{part['put_secs']:.3f} s, pad_frac {part['pad_frac']}, "
              f"comm_bytes_per_step {part['comm_bytes_per_step']}; float64 L1 {l1_64:.3g} vs one "
              f"device, float32 L1 {l1_32:.3g}; {differ} entries differ over two float32 runs; "
              f"float32 {from_one} of {graph.n_nodes} entries differ in bits from the "
              f"one-device segment run; launches {launched}")
        check(r64.iterations == r32.iterations == ITERS, f"{label}: iterations")
        check(bool(np.isfinite(r32.ranks).all()) and r32.ranks.shape == (graph.n_nodes,),
              f"{label}: ranks not finite or wrong shape")
        check(l1_64 <= 1e-9, f"{label}: float64 L1 {l1_64} from the single-device run > 1e-9")
        check(l1_32 <= 1e-3, f"{label}: float32 L1 {l1_32} from float64 > 1e-3")
        check(differ == 0, f"{label}: two runs differ in {differ} entries")
        if impl == "segment" and strategy in ONE_DEVICE_BITS:
            check(from_one == 0, f"{label}: float32 {from_one} entries differ in bits from the "
                                 "one-device segment run")
        if impl == "segment":
            check(launched["segment"] >= d * ITERS, f"{label}: segment launched "
                                                     f"{launched['segment']} times")
        else:
            check(launched["cumsum"] >= d * ITERS, f"{label}: cumsum launched "
                                                    f"{launched['cumsum']} times")
        if strategy == "hybrid":
            check(launched["rowsum"] >= ITERS, f"{label}: rowsum launched "
                                               f"{launched['rowsum']} times")
    return total


def sharded_shrink_phase(graph, reset_counts, counts, kept: dict) -> dict:
    """16c: owned and edges at 4 slots, float64, a checkpoint every 5, under
    slot 1 lost at the step and slot 2 at the rerun: one degraded event a
    shrink with the reference's ladder and counts (4 -> 2 -> 1), ranks
    within 1e-9 L1 of the unbroken run; then owned in float32 under the
    same plan, bit for bit equal to the unbroken float32 runs (16b's owned
    at 4 slots and the one-device run).  Returns the launches."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import run_pagerank
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import run_pagerank_sharded
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos, elastic
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.metrics import MetricsRecorder

    base = dict(iterations=ITERS, dangling="redistribute", init="uniform", dtype="float64")
    ref = run_pagerank(graph, PageRankConfig(**base), device="cuda").ranks
    total: dict = {}
    runs = [("owned", "float64"), ("edges", "float64"), ("owned", "float32")]
    for strategy, dtype in runs:
        elastic.reset_health()
        m = MetricsRecorder()
        with tempfile.TemporaryDirectory() as tmp:
            cfg = PageRankConfig(**{**base, "dtype": dtype}, checkpoint_every=5,
                                 checkpoint_dir=tmp)
            reset_counts()
            t0 = time.perf_counter()
            with chaos.inject(SHRINK_PLAN):
                res = run_pagerank_sharded(graph, cfg, mesh=card_mesh(SHARD_SLOTS),
                                           strategy=strategy, metrics=m)
            secs = time.perf_counter() - t0
            add_counts(total, counts())
        elastic.reset_health()
        ladder = [(r["ladder"], r["devices_old"], r["devices_new"])
                  for r in m.records if r.get("event") == "degraded"]
        parts = [r["devices"] for r in m.records if r.get("event") == "partition"]
        label = f"16c {strategy} {dtype}"
        if dtype == "float32":
            one = bits_differ(res.ranks, kept["one device", "float32"])
            unbroken = bits_differ(res.ranks, kept[strategy, SHARD_SLOTS, "segment", dtype][0])
            held = (f"{unbroken} entries differ in bits from the unbroken {SHARD_SLOTS}-slot "
                    f"run, {one} from the one-device run")
            ok = unbroken == one == 0
        else:
            l1 = float(np.abs(res.ranks - ref).sum())
            held = f"float64 L1 {l1:.3g} from the unbroken single-device run"
            ok = l1 <= 1e-9
        print(f"{label} under {SHRINK_PLAN}: degraded {ladder}, partitions over {parts} "
              f"slots, {res.iterations} iterations in {secs:.2f} s, {held}")
        check(ladder == SHRINK_LADDER, f"{label}: ladder {ladder}, wanted {SHRINK_LADDER}")
        check(parts == [4, 2, 1], f"{label}: partitions {parts}")
        check(res.iterations == ITERS and ok, f"{label}: {held}, {res.iterations} iterations")
    return total


def sharded_tfidf_phase(stream: dict, card_label: str) -> None:
    """16d: run_tfidf_sharded over config 2 at 4 slots against the port's
    run_tfidf_streaming on the same chunks: COO, counts and DF exact,
    weights within 2e-6; whether the bits are equal is printed."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models import tfidf as tm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import run_tfidf_sharded
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import DATA_AXIS
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    chunks = chunked(stream["docs"], stream["chunk_docs"])
    cfg = tcfg.TfidfConfig(**stream["knobs"], idf_mode="smooth", l2_normalize=True)
    t0 = time.perf_counter()
    want = tm.run_tfidf_streaming(iter(chunks), cfg, device="cuda")
    t1 = time.perf_counter()
    got = run_tfidf_sharded(iter(chunks), cfg, mesh=card_mesh(SHARD_SLOTS, DATA_AXIS))
    t2 = time.perf_counter()
    for f in ("doc", "term", "count", "df"):
        check(np.array_equal(getattr(got, f), getattr(want, f)), f"16d: {f} differs")
    err = float(np.abs(got.weight - want.weight).max())
    same = all(getattr(got, f).tobytes() == getattr(want, f).tobytes()
               for f in ("weight", "idf"))
    sc = [r for r in got.metrics.records if r.get("event") == "super_chunk"]
    print(f"16d tfidf config 2 at {SHARD_SLOTS} slots ({card_label}): {got.nnz} pairs, "
          f"{len(sc)} super-chunks in {t2 - t1:.3f} s against the stream's {t1 - t0:.3f} s; "
          f"COO, counts, DF equal; weights max abs {err:.3g}; bits equal: {same}")
    check(err <= 2e-6, f"16d: weights {err} > 2e-6")
    n_chunks = sum(1 for r in want.metrics.records if r.get("event") == "chunk")
    check(sum(r["devices"] for r in sc) == n_chunks,
          f"16d: {sum(r['devices'] for r in sc)} chunks ingested, the stream's {n_chunks}")


def sharded_workloads_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """16e: PPR (B = 8, 10 iterations, segment), HITS (tol 1e-8) and
    components at 4 slots against the single-device runs at phase 12's
    bars: PPR float64 within 1e-12, float32 within L1 1e-3 of float64;
    HITS float64 within 1e-12; labels equal.  Returns the launches."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.components import (
        run_components,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.hits import run_hits
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow.ppr import run_ppr_batch
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import workloads_sharded as ws
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import DATA_AXIS
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        HitsConfig,
        PageRankConfig,
    )

    total: dict = {}
    rng = np.random.default_rng(SEED)
    queries = [[int(graph.node_ids[i])] for i in rng.integers(0, graph.n_nodes, size=PPR_BATCH)]
    ppr = {}
    for dtype in ("float64", "float32"):
        cfg = PageRankConfig(iterations=PPR_ITERS, dangling="redistribute", init="uniform",
                             dtype=dtype)
        reset_counts()
        t0 = time.perf_counter()
        ppr[dtype] = ws.run_ppr_sharded(graph, cfg, queries,
                                        mesh=card_mesh(SHARD_SLOTS, DATA_AXIS)).ranks
        secs = time.perf_counter() - t0
        launched = counts()
        add_counts(total, launched)
        check(launched["segment"] == PPR_BATCH * PPR_ITERS,
              f"16e ppr {dtype}: launches {launched}")
        print(f"16e ppr {dtype} at {SHARD_SLOTS} slots ({card_label}): B={PPR_BATCH} x "
              f"{PPR_ITERS} iterations in {secs:.3f} s (graph placement included); launches "
              f"{launched}")
    single = run_ppr_batch(graph, PageRankConfig(iterations=PPR_ITERS, dangling="redistribute",
                                                 init="uniform", dtype="float64"),
                           queries, device="cuda").ranks
    e64 = float(np.abs(ppr["float64"] - single).max())
    l1 = float(np.abs(ppr["float32"].astype(np.float64) - ppr["float64"]).sum(axis=1).max())
    check(e64 <= 1e-12 and l1 <= 1e-3, f"16e ppr: float64 {e64}, float32 L1 {l1}")

    cfg = HitsConfig(iterations=HITS_ITERS, tol=HITS_TOL, dtype="float64")
    reset_counts()
    t0 = time.perf_counter()
    hits = ws.run_hits_sharded(graph, cfg, mesh=card_mesh(SHARD_SLOTS))
    secs = time.perf_counter() - t0
    launched = counts()
    add_counts(total, launched)
    one = run_hits(graph, cfg, device="cuda")
    eh = max(float(np.abs(hits.hubs - one.hubs).max()),
             float(np.abs(hits.authorities - one.authorities).max()))
    check(hits.iterations == one.iterations and eh <= 1e-12,
          f"16e hits: {eh} from one device, {hits.iterations}/{one.iterations} iterations")
    check(launched["segment"] == 2 * SHARD_SLOTS * hits.iterations,
          f"16e hits: launches {launched}")

    reset_counts()
    cc = ws.run_components_sharded(graph, mesh=card_mesh(SHARD_SLOTS))
    add_counts(total, counts())
    base = run_components(graph, device="cuda")
    check(np.array_equal(cc.labels, base.labels) and cc.converged, "16e components: labels differ")
    print(f"16e ppr float64 max abs {e64:.3g} from one device, float32 worst row L1 {l1:.3g}; "
          f"hits {hits.iterations} iterations in {secs:.3f} s, max abs {eh:.3g}, launches "
          f"{launched}; components {cc.n_components} in {cc.iterations} rounds, labels equal")
    return total


def sharded_cli_phase(graph) -> None:
    """16f: cli.pagerank --mesh N --shard-strategy auto equal to the API over
    N visible cards (N = 1 on one card); --mesh beyond the visible cards
    fails with the reference's message."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as cli
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import save_ranks
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel import run_pagerank_sharded
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.parallel.mesh import make_mesh
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    n = torch.cuda.device_count()
    cards = len(set(SLOT_DEVICES)) if len(set(SLOT_DEVICES)) > 1 else 1
    with tempfile.TemporaryDirectory() as tmp:
        out, want = os.path.join(tmp, "cli.tsv"), os.path.join(tmp, "api.tsv")
        rc = cli.main([f"synthetic:{N_NODES},{N_EDGES},{SEED}", str(ITERS), "--dangling",
                       "redistribute", "--init", "uniform", "--mesh", str(cards),
                       "--shard-strategy", "auto", "--output", out, "--tuned-profile", "off"])
        check(rc == 0, f"16f: the CLI exited {rc}")
        res = run_pagerank_sharded(graph, PageRankConfig(
            iterations=ITERS, dangling="redistribute", init="uniform"), mesh=make_mesh(cards),
            strategy="auto")
        save_ranks(want, graph, res.ranks)
        with open(out) as f_cli, open(want) as f_api:
            same = f_cli.read() == f_api.read()
        check(same, f"16f: the CLI's --mesh {cards} output differs from the API's")
        try:
            cli.main([f"synthetic:{N_NODES},{N_EDGES},{SEED}", "2", "--mesh", str(n + 1),
                      "--output", os.path.join(tmp, "x.tsv"), "--tuned-profile", "off"])
            check(False, f"16f: --mesh {n + 1} ran on {n} card(s)")
        except ValueError as exc:
            check(f"requested {n + 1} devices but only {n} available" in str(exc),
                  f"16f: --mesh {n + 1} raised {exc}")
            msg = str(exc)
    chosen = [r for r in res.metrics.records if r.get("event") == "auto_strategy"]
    print(f"16f: cli.pagerank --mesh {cards} --shard-strategy auto (chose "
          f"{chosen[0]['chosen']}) byte-equal to the API's ranks; --mesh {n + 1}: {msg}")


def sharded_phase(graph, stream: dict, reset_counts, counts, card_label: str) -> dict:
    """Phase 16 (see the module docstring).  Returns the launches of its
    runs by sub-phase."""
    launches = {}
    kept: dict = {}
    t0 = time.perf_counter()
    collectives_phase()
    launches["sharded"] = sharded_pagerank_phase(graph, reset_counts, counts, card_label, kept)
    print(f"phase 16b: {time.perf_counter() - t0:.1f} s")
    launches["shrink"] = sharded_shrink_phase(graph, reset_counts, counts, kept)
    sharded_tfidf_phase(stream, card_label)
    launches["sharded_workloads"] = sharded_workloads_phase(graph, reset_counts, counts,
                                                            card_label)
    sharded_cli_phase(graph)
    t0 = time.perf_counter()
    launches["distributed"] = distributed_phase(graph, stream, kept, card_label)
    print(f"phase 16g: {time.perf_counter() - t0:.1f} s")
    return launches


# 16g: the mesh across processes.  On one card MESH_PROCESSES processes share
# cuda:0 over gloo (their tensors cross through the host), each owning
# SHARD_SLOTS / MESH_PROCESSES slots; under --cards one process a card over
# NCCL, one slot each.  TF-IDF and the workloads run one slot a process.
MESH_PROCESSES, MESH_DEADLINE_S = 2, 420.0


def mesh_cases(graph, stream: dict, tmp: str, per: int) -> list:
    """16g's cases (``tools/mesh_processes.py``): every strategy in float32
    under segment (``hybrid`` launches rowsum.cu), ``edges`` under cumsum,
    ``nodes`` in float64, ``owned`` stopped at 10 and resumed to 20, then
    TF-IDF (config 2) and PPR/HITS/components at 16d's and 16e's settings."""
    base = dict(iterations=ITERS, dangling="redistribute", init="uniform")
    f32 = dict(base, dtype="float32", spmv_impl="segment")
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, graph.n_nodes, size=PPR_BATCH)
    cases = [dict(name=f"pagerank-{s}", kind="pagerank", strategy=s, slots=per, cfg=f32)
             for s in SHARD_STRATEGIES]
    cases += [
        dict(name="pagerank-edges-cumsum", kind="pagerank", strategy="edges", slots=per,
             cfg=dict(f32, spmv_impl="cumsum")),
        dict(name="pagerank-nodes-f64", kind="pagerank", strategy="nodes", slots=per,
             cfg=dict(f32, dtype="float64")),
        dict(name="resume-owned", kind="resume", strategy="owned", slots=per, cfg=f32,
             stop_at=10, every=5, checkpoint_dir=os.path.join(tmp, "resume")),
        dict(name="tfidf", kind="tfidf", slots=1, chunk_docs=stream["chunk_docs"],
             cfg=dict(stream["knobs"], idf_mode="smooth", l2_normalize=True)),
        dict(name="ppr", kind="ppr", slots=1, queries=[[int(graph.node_ids[i])] for i in idx],
             cfg=dict(base, iterations=PPR_ITERS, dtype="float64")),
        dict(name="hits", kind="hits", slots=1,
             cfg=dict(iterations=HITS_ITERS, tol=HITS_TOL, dtype="float64")),
        dict(name="cc", kind="cc", slots=1),
    ]
    return cases


def nccl_refusal_phase(mp) -> None:
    """16g: two NCCL processes on the one card raise, each naming the card;
    nothing turns them into gloo."""
    try:
        mp.spawn([], {}, processes=MESH_PROCESSES, device="cuda:0", backend="nccl",
                 timeout_s=120.0)
        check(False, "16g: two NCCL processes ran on one card")
    except RuntimeError as exc:
        msg = str(exc)
        check(msg.count("cannot run two processes on one card") == MESH_PROCESSES,
              f"16g: NCCL on one card failed otherwise: {msg[-2000:]}")
    print(f"16g NCCL with {MESH_PROCESSES} processes on one card: each raised ValueError "
          "(cannot run two processes on one card), no fallback to gloo")


def distributed_phase(graph, stream: dict, kept: dict, card_label: str) -> dict:
    """16g: one mesh across processes (``parallel.init_distributed``) on the
    card, every result bit-equal on every process and to the one-process
    mesh of the same slots (16b's runs; for TF-IDF and the workloads, the
    parent's own over one slot a process), each child's kernel launches
    counted, iterations/s beside 16b's.  Returns the children's launches."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import mesh_processes as mp

    nccl = len(set(SLOT_DEVICES)) > 1  # --cards: one process a card
    procs = SHARD_SLOTS if nccl else MESH_PROCESSES
    per = SHARD_SLOTS // procs
    backend = "nccl" if nccl else "gloo"
    env = None
    if nccl:
        vis = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = vis.split(",") if vis else [str(i) for i in range(torch.cuda.device_count())]
        env = [{"CUDA_VISIBLE_DEVICES": cards[r]} for r in range(procs)]
    else:
        nccl_refusal_phase(mp)
    data = {"graph": (N_NODES, N_EDGES, SEED), "corpus": (TFIDF_DOCS, TFIDF_TOKENS, TFIDF_SEED)}
    with tempfile.TemporaryDirectory() as tmp:
        cases = mesh_cases(graph, stream, tmp, per)
        t0 = time.perf_counter()
        outs = mp.spawn(cases, data, processes=procs, device=SLOT_DEVICES[0] if not nccl
                        else "cuda:0", backend=backend, timeout_s=MESH_DEADLINE_S, env=env)
        wall = time.perf_counter() - t0
    where = (f"{procs} processes, one card each, over NCCL" if nccl else
             f"{procs} processes sharing one card over gloo, {per} slots each; not "
             "multi-GPU scaling")
    total: dict = {}
    for out in outs:
        check(out["_process"]["jax_loaded"] == [], f"16g: a process imported "
                                                   f"{out['_process']['jax_loaded']}")
        for c in cases:
            add_counts(total, out[c["name"]]["info"]["launches"])
    cache = {"graph": graph, "docs": stream["docs"]}
    for c in cases:
        name, got = c["name"], outs[0][c["name"]]
        for p in range(1, procs):
            check(outs[p][name]["digests"] == got["digests"],
                  f"16g {name}: process {p}'s result differs from process 0's")
        info = got["info"]
        check(info.get("processes") == procs and info.get("backend") == backend,
              f"16g {name}: ran on {info.get('processes')} processes over {info.get('backend')}")
        if c["kind"] in ("pagerank", "resume"):
            impl, dtype = c["cfg"]["spmv_impl"], c["cfg"]["dtype"]
            want, rate16b = kept[(c["strategy"], SHARD_SLOTS, impl, dtype)]
            want = {"ranks": want}
        else:
            one = mp.run_case(c, data, mp.case_mesh(c, procs, SLOT_DEVICES, spread=False),
                              cache)
            want, rate16b = one["arrays"], None
        check(all(got["arrays"][k].shape == v.shape and got["arrays"][k].dtype == v.dtype
                  for k, v in want.items()) and got["arrays"].keys() == want.keys(),
              f"16g {name}: arrays of other names, shapes or types than the one-process mesh's")
        differ = {k: (bits_differ(got["arrays"][k], v) if v.dtype.kind == "f"
                      else int((got["arrays"][k] != v).sum())) for k, v in want.items()}
        launched = [outs[p][name]["info"]["launches"] for p in range(procs)]
        rate = info.get("iters_per_sec")
        print(f"16g {name} ({card_label}; {where}): {info['secs']:.3f} s in process 0"
              + (f", {rate:.2f} iterations/s against 16b's {rate16b:.2f}"
                 if rate is not None and rate16b is not None else "")
              + f"; entries differing from the one-process mesh {differ}; launches a "
                f"process {launched}")
        check(all(n == 0 for n in differ.values()),
              f"16g {name}: differs from the one-process mesh: {differ}")
        if c["kind"] == "pagerank":
            seg = sum(lp["segment"] for lp in launched)
            if c["cfg"]["spmv_impl"] == "segment":
                check(seg >= SHARD_SLOTS * ITERS, f"16g {name}: segment launched {seg} times")
            else:
                cum = sum(lp["cumsum"] for lp in launched)
                check(cum >= SHARD_SLOTS * ITERS, f"16g {name}: cumsum launched {cum} times")
            if c["strategy"] == "hybrid":
                rows = sum(lp["rowsum"] for lp in launched)
                check(rows >= ITERS, f"16g {name}: rowsum launched {rows} times")
        if c["kind"] == "resume":
            check(all(outs[p][name]["info"]["resumed_at"] == [5] for p in range(procs)),
                  f"16g {name}: resumed at {info.get('resumed_at')}")
    for k in ("segment", "rowsum", "cumsum"):
        check(total.get(k, 0) > 0, f"16g: {k} never launched in the processes")
    print(f"16g mesh across {procs} processes ({where}): {len(cases)} runs bit-equal on every "
          f"process and to the one-process mesh, {wall:.1f} s wall from spawn to the last "
          f"report (each process's start, graph and corpus build included); launches {total}")
    return total


# ---------------------------------------------------------------- phase 17

# The fleet (serving/fabric.py) serves 11c's config-5 stand-in sealed as
# SEGMENTS segments with FLEET_REPLICAS replica processes on the card behind
# the router; FLEET_CLIENTS closed-loop clients send phase 11's query
# generator's SERVE_QUERIES queries over that corpus.  17c scales up one
# replica whose environment carries replica_query:proc_kill@FLEET_KILL_AT;
# 17h's CLI replica answers the first FLEET_CLI_QUERIES queries; 17e's
# in-process pair peeks FLEET_PEER_KEYS keys per check.  17f runs the soak at
# tests/test_soak.py:41-46's settings; 17g runs the fleet soak at
# tests/test_fabric.py:548-551's qps, clients, replicas and rebuild period,
# over a longer run sized to the card's respawn (9.8-11.4 s from the kill to
# ready): the roll waits until the replacement is serving, so the soak sees
# the recovery its record's time_to_recover_s reads.
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_KILL_AT = 2, 4, 3
FLEET_CLI_QUERIES, FLEET_PEER_KEYS = 256, 24
FLEET_MODULE = "page_rank_and_tfidf_using_apache_spark_tpu_torch.serving.fabric"
FLEET_DEVICE, FLEET_BACKEND = "cuda", "gpu"
SOAK_SETTINGS = dict(duration_s=6.0, qps=20.0, clients=2, rebuild_every_s=2.5,
                     chunk_interval_s=0.3, prior_refresh_every_s=2.0, losses=1,
                     loss_at_s=2.0, grace_s=20.0)
FLEET_SOAK_SETTINGS = dict(duration_s=45.0, qps=6.0, clients=2, replicas=2,
                           rebuild_every_s=6.0, kill_at_s=5.0, roll_at_s=30.0)
# the reference's record keys (serving/soak.py's two _score methods);
# tests/test_torch_soak.py holds the port's records to the reference's
SOAK_RECORD_KEYS = {
    "duration_s", "requests", "attempts", "qps", "served_p50_ms", "served_p95_ms",
    "served_p99_ms", "served_p99_cumulative_ms", "client_e2e_p99_ms", "error_budget",
    "errors", "recovery", "dropped", "double_served", "ingest", "contention",
    "chaos_injections", "chaos_losses", "mixed_traffic", "slo_targets", "endpoint",
    "backend"}
FLEET_RECORD_KEYS = {
    "duration_s", "requests", "attempts", "qps", "served_p50_ms", "served_p95_ms",
    "served_p99_ms", "client_e2e_p99_ms", "error_budget", "errors", "recovery", "dropped",
    "double_served", "ingest", "fleet", "cache", "autoscale", "mixed_traffic",
    "slo_targets", "backend"}
# the soak's prior against a device="cpu" run: phase 4's float32 bar, L1 of
# the ranks on the sum-1 scale (the prior is normalized to mean 1)
PRIOR_DOCS, PRIOR_L1 = 2_000, 1e-3


def compute_apps() -> str:
    """``nvidia-smi --query-compute-apps=pid,used_memory`` as it prints them.
    In a container's PID namespace it cannot map the card's processes to
    the container's pids (it may list one pid, 1, holding the card's whole
    use), so the fleet's checks read :func:`card_holders` and
    :func:`card_used_mib` instead."""
    return subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().replace("\n", "; ")


def card_used_mib() -> int:
    """The card's used memory, MiB, as ``nvidia-smi --query-gpu=memory.used``
    reports it."""
    return int(subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                               "--format=csv,noheader,nounits"], capture_output=True,
                              text=True, check=True, timeout=60).stdout.split()[0])


def dev_files(pid: int) -> list:
    """The ``/dev`` files process ``pid`` holds open."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            link = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if link.startswith("/dev/"):
            out.add(link)
    return sorted(out)


def card_holders(module: str = FLEET_MODULE) -> set:
    """Pids of processes running ``module`` that hold a card's device file
    open (``/proc/<pid>/fd`` -> ``/dev/nvidiaN``; the machine decides which
    N the card is): a replica with a CUDA context."""
    import re

    card_file = re.compile(r"/dev/nvidia\d+$")
    pids = set()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                if module.encode() not in f.read():
                    continue
            fds = os.listdir(f"/proc/{d}/fd")
            if any(card_file.match(os.readlink(f"/proc/{d}/fd/{fd}")) for fd in fds):
                pids.add(int(d))
        except OSError:
            continue  # exited meanwhile
    return pids


def fleet_post(port: int, path: str, doc: dict, timeout: float = 60.0) -> tuple:
    """One JSON POST to a replica: (status, parsed body, raw body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(doc).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, json.loads(raw), raw
    except urllib.error.HTTPError as exc:
        raw = exc.read()
        return exc.code, json.loads(raw), raw


def healthz(port: int) -> int:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as exc:
        return exc.code


def fleet_loop(fn, items: list, clients: int) -> tuple[list, list, float]:
    """``clients`` closed-loop threads sharing ``items``: the results in
    ``items``' order, each call's seconds, and the wall seconds."""
    import threading

    out, lat, errors = [None] * len(items), [], []
    lock = threading.Lock()

    def client(c: int) -> None:
        try:
            for i in range(c, len(items), clients):
                t0 = time.perf_counter()
                out[i] = fn(items[i])
                with lock:
                    lat.append(time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — reported by the caller
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,), name=f"smoke-client-{c}")
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"fleet clients failed: {errors[:3]}")
    return out, sorted(lat), wall


def pct_ms(xs: list, p: float) -> float:
    return float(np.percentile(np.asarray(xs), p)) * 1e3 if xs else float("nan")


def check_fleet_answers(got: list, want: list, label: str) -> int:
    """11c's bar: scores within SEGMENT_ATOL of the in-process server's, ids
    equal wherever its scores stand apart; returns the answers equal bit for
    bit."""
    same = 0
    for (s, i), (ws, wi) in zip(got, want):
        check(s.shape == ws.shape and np.allclose(s, ws, atol=SEGMENT_ATOL, rtol=0.0),
              f"{label}: scores {s[:4]} vs the in-process server's {ws[:4]}")
        gap = 2 * SEGMENT_ATOL
        for j in range(len(ws)):
            apart = ((j == 0 or ws[j - 1] - ws[j] > gap)
                     and (j == len(ws) - 1 or ws[j] - ws[j + 1] > gap))
            if apart:
                check(i[j] == wi[j], f"{label}: id {i[j]} at {j} vs {wi[j]}")
        same += int(s.tobytes() == ws.tobytes() and np.asarray(i, np.int32).tobytes()
                    == np.asarray(wi, np.int32).tobytes())
    return same


def fleet_spawn_times(events: list) -> list:
    """Each replica's handshake seconds in start order, from the
    ``fabric_start`` and ``fabric_spawn`` events (ServingFabric.start spawns
    one replica after the other)."""
    t = [e["t"] for e in events if e["kind"] in ("fabric_start", "fabric_spawn")]
    return [b - a for a, b in zip(t, t[1:])]


def seal_fleet_index(seg_dir: str, wiki, cfg, device, segments: int) -> float:
    """11c's sealing: ``segments`` equal parts of the corpus, each sealed and
    committed with ``commit_append``; returns the seconds."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    t0 = time.perf_counter()
    per = len(wiki) // segments
    base = 0
    for s in range(segments):
        part = wiki[s * per:(s + 1) * per if s < segments - 1 else len(wiki)]
        out = run_tfidf(part, cfg, device=device)
        ref = sgm.seal_segment(seg_dir, out, cfg, doc_base=base, bm25=tcfg.Bm25Config())
        sgm.commit_append(seg_dir, ref, cfg.config_hash())
        base += out.n_docs
    return time.perf_counter() - t0


def cli_replica(seg_dir: str, extra: tuple = ()):
    """The fabric's CLI (``python -m ...serving.fabric --replica``) on the
    card, through the supervisor's handshake; returns (handle, seconds)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import process as procs

    t0 = time.perf_counter()
    handle = procs.ProcessHandle(
        [sys.executable, "-m", FLEET_MODULE, "--replica", seg_dir, "--replica-id", "9",
         "--port", "0", "--top-k", str(QUERY_K), "--device", FLEET_DEVICE, *extra],
        env=procs.fabric_pgid_env(), ready_timeout_s=300.0).spawn()
    return handle, time.perf_counter() - t0


def peer_pair_phase(seg_dir: str, queries: list, card_label: str) -> None:
    """17e's faults, on two in-process replicas on the card wired as each
    other's peers (the peer hops' faults live in the replica's process, so
    they are injected here, in this one): a partitioned peek trips the
    owner's breaker, which half-opens and closes once the partition heals;
    under a hung peek the non-owner's p99 stays within the peek deadline of
    its p99 with no fault.  The passes are timed with the cycle collector
    held off, as ``timeit`` times: the hung pass's abandoned peeks leave
    cycles, and a full collection of this script's heap, grown over the
    earlier phases, is a pause of the script, not of the peek path (its
    length here is printed)."""
    import gc

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.export import MetricsExporter
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.obs.metrics import MetricsHub
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.resilience import chaos
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric

    os.environ["GRAFT_CACHE_BREAKER_PROBE_S"] = "0.5"
    sink = obs.MemorySink()
    obs.bus().attach(sink)
    deadline_s = fabric._peer_knobs()[0]
    reps = [fabric._Replica(seg_dir, replica_id=i, top_k=QUERY_K, max_batch=None,
                            scoring="coo", poll_s=5.0, device=FLEET_DEVICE).start()
            for i in (0, 1)]
    exporters = [MetricsExporter(MetricsHub(), port=0, routes={
        ("POST", "/query"): r.handle_query, ("GET", "/status"): r.handle_status,
        ("POST", "/cache/peek"): r.handle_cache_peek,
        ("POST", "/cache/fill"): r.handle_cache_fill,
        ("POST", "/peers"): r.handle_peers}, ready=r.ready).start() for r in reps]
    gc_on = gc.isenabled()
    try:
        check(all(r.ready() for r in reps), "in-process replicas not ready")
        t0 = time.perf_counter()
        gc.collect()
        full_gc_ms = (time.perf_counter() - t0) * 1e3
        gc.disable()
        for r in reps:
            r.configure_peers({i: e.port for i, e in enumerate(exporters)})
        a, b = reps
        ring = fabric._Ring([0, 1], 64)
        by_key = {fabric.affinity_key(q, "tfidf"): tuple(q) for q in queries}
        owned = [q for k, q in by_key.items() if ring.route(k)[0] == 0]
        groups = [owned[g * FLEET_PEER_KEYS:(g + 1) * FLEET_PEER_KEYS] for g in range(3)]
        check(len(groups[2]) == FLEET_PEER_KEYS, f"only {len(owned)} keys owned by 0")
        rid = iter(range(10**6))

        def ask(rep, q) -> tuple:
            t0 = time.perf_counter()
            code, _, body = rep.handle_query(json.dumps(
                {"rid": f"pp-{next(rid)}", "terms": list(q), "ranker": "tfidf"}).encode())
            check(code == 200, f"in-process replica answered {code}: {body[:200]}")
            doc = json.loads(body)
            return (json.dumps(doc["scores"]), json.dumps(doc["docs"])), \
                time.perf_counter() - t0

        # the owner computes every key first; B's answers must equal its bytes
        want = {q: ask(a, q)[0] for g in groups for q in g}
        # a clean pass: B's own compute cost with peer hits (latency baseline)
        clean = [ask(b, q) for q in groups[0]]
        check(all(x[0] == want[q] for x, q in zip(clean, groups[0])),
              "peer hits differ from the owner's bytes")
        base_p99 = pct_ms([x[1] for x in clean], 99)
        hits0 = b._peer_stats["peer_hits"] + b._peer_stats["nonowner_local_hits"]
        check(hits0 == len(groups[0]), f"{hits0} peer hits of {len(groups[0])} peeks")
        # partition: trips after GRAFT_CACHE_BREAKER_TRIP failures, then the
        # peeks are skipped; healed, the half-open probe closes it
        # the owner partitioned on both peer hops (a fill that got through
        # would count as a success and reset the breaker)
        with chaos.inject("cache_peek:net_partition@1+;cache_fill:net_partition@1+"):
            part = [ask(b, q) for q in groups[1][:8]]
            drain = time.monotonic() + 10.0
            while not b._fill_q.empty() and time.monotonic() < drain:
                time.sleep(0.02)
        check(all(x[0] == want[q] for x, q in zip(part, groups[1][:8])),
              "answers under a partitioned peek differ from the owner's")
        tripped = (b._breakers[0].state, b._peer_stats["breaker_trips"],
                   b._peer_stats["peeks_skipped_open"])
        check(tripped[0] == "open" and tripped[1] == 1 and tripped[2] >= 1,
              f"partition: breaker {tripped}")
        time.sleep(0.6)
        healed = ask(b, groups[1][8])
        check(healed[0] == want[groups[1][8]] and b._breakers[0].state == "closed",
              f"healed: breaker {b._breakers[0].state}")
        moves = [(e["old"], e["new"]) for e in sink.of_kind("cache_breaker")
                 if e["replica"] == 1 and e["peer"] == 0]
        transitions = len(moves)
        check(moves[:1] == [("closed", "open")]
              and moves[-2:] == [("open", "half_open"), ("half_open", "closed")],
              f"breaker transitions {moves}")
        # a hung owner: each request pays at most the deadline over its own cost
        with chaos.inject("cache_peek:net_hang@%1:2000"):
            hung = [ask(b, q) for q in groups[2]]
        check(all(x[0] == want[q] for x, q in zip(hung, groups[2])),
              "answers under a hung peek differ from the owner's")
        hang_p99 = pct_ms([x[1] for x in hung], 99)
        check(hang_p99 <= base_p99 + deadline_s * 1e3 + 100.0,
              f"hung peek: p99 {hang_p99:.1f} ms over {base_p99:.1f} + deadline "
              f"{deadline_s * 1e3:.0f} ms")
        print(f"fleet 17e peer pair (in-process, {card_label}): {len(groups[0])} peer hits "
              f"byte-equal to the owner, p99 {base_p99:.2f} ms; cache_peek:net_partition "
              f"(and cache_fill) tripped the breaker (trips {tripped[1]}, peeks skipped "
              f"{tripped[2]}), "
              f"half-open probe closed it ({transitions} transitions); under "
              f"cache_peek:net_hang (2 s) p99 {hang_p99:.2f} ms, max "
              f"{max(x[1] for x in hung) * 1e3:.2f} ms, deadline {deadline_s * 1e3:.0f} ms, "
              f"peek timeouts {b._peer_stats['peek_timeouts']}; collector held off (a full "
              f"collection of this script's heap: {full_gc_ms:.1f} ms)")
    finally:
        if gc_on:
            gc.enable()
        obs.bus().detach(sink)
        for e in exporters:
            e.stop()
        for r in reps:
            r.stop()
        os.environ.pop("GRAFT_CACHE_BREAKER_PROBE_S", None)


def soak_phase(reset_counts, counts, card_label: str) -> dict:
    """17f: ``run_soak`` on the card at the reference test's settings; the
    prior's launches; one prior refresh against ``device="cpu"``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import soak

    sink = obs.MemorySink()
    obs.bus().attach(sink)
    reset_counts()
    try:
        t0 = time.perf_counter()
        rec = soak.run_soak(soak.SoakConfig(**SOAK_SETTINGS, device=FLEET_DEVICE))
        wall = time.perf_counter() - t0
    finally:
        obs.bus().detach(sink)
    launched = counts()
    check(set(rec) == SOAK_RECORD_KEYS, f"soak record keys {sorted(set(rec) ^ SOAK_RECORD_KEYS)}")
    rcv = rec["recovery"]
    check(rec["dropped"] == 0 and rec["double_served"] == 0,
          f"soak: dropped {rec['dropped']}, served twice {rec['double_served']}")
    check(rcv["losses_injected"] == 1 and len(rcv["recoveries"]) == 1,
          f"soak recoveries {rcv}")
    check(rec["backend"] == FLEET_BACKEND, f"soak backend {rec['backend']}")
    check(launched.get("segment", 0) > 0, f"soak prior launched {launched}")
    check(not sink.of_kind("degraded"), "the soak published a degraded event")
    order = [e["kind"] for e in sink.events
             if e["kind"] in ("soak_loss_injected", "soak_recovered")]
    check(order == ["soak_loss_injected", "soak_recovered"], f"soak events {order}")
    ing = rec["ingest"]
    print(f"fleet 17f soak ({card_label}): {wall:.1f} s wall, {rec['requests']} requests at "
          f"{rec['qps']} queries/s, served p50 {rec['served_p50_ms']} ms p99 "
          f"{rec['served_p99_ms']} ms, availability burn "
          f"{rec['error_budget']['availability']['burn_rate']}, time to recover "
          f"{rcv['time_to_recover_s']} s, dropped 0, served twice 0; ingest {ing['chunks']} "
          f"chunks, {ing['rebuilds']} seals, {ing['prior_refreshes']} prior refreshes, "
          f"commit to servable max {ing['commit_to_servable_s']['max']} s; launches {launched}")
    t0 = time.perf_counter()
    gpu = soak._prior_ranks(PRIOR_DOCS, 7, 5, FLEET_DEVICE)
    gpu_s = time.perf_counter() - t0
    cpu = soak._prior_ranks(PRIOR_DOCS, 7, 5, "cpu")
    l1 = float(np.abs(gpu.astype(np.float64) - cpu).sum()) / PRIOR_DOCS
    check(l1 <= PRIOR_L1, f"prior refresh: L1 {l1} vs device='cpu' > {PRIOR_L1}")
    print(f"fleet 17f prior refresh ({PRIOR_DOCS} docs, 5 iterations, segment): L1 "
          f"{l1:.3g} on the sum-1 scale vs device='cpu' (bar {PRIOR_L1:g}), max abs "
          f"{float(np.abs(gpu - cpu).max()):.3g}, bits equal {bits_differ(gpu, cpu) == 0}; "
          f"{gpu_s:.2f} s on the card")
    return launched


def fleet_soak_phase(card_label: str) -> None:
    """17g: ``run_fleet_soak`` with 2 replicas on the card; the root
    ``tools/slo_watch.py --once --fleet`` against its router meanwhile."""
    import threading

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import soak

    sink = obs.MemorySink()
    obs.bus().attach(sink)
    box: dict = {}

    def run() -> None:
        try:
            box["rec"] = soak.run_fleet_soak(soak.FleetSoakConfig(**FLEET_SOAK_SETTINGS,
                                                                  device=FLEET_DEVICE))
        except Exception as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc

    t0 = time.perf_counter()
    worker = threading.Thread(target=run, name="smoke-run")
    worker.start()
    try:
        url = None
        while url is None and worker.is_alive():
            url = next((e["url"] for e in sink.events if e["kind"] == "fabric_fleet_export"),
                       None)
            time.sleep(0.1)
        check(url is not None, f"the fleet soak exported no fleet endpoint: {box}")
        time.sleep(3.0)  # a few scrapes of both replicas
        watch = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "slo_watch.py"),
                                "--url", url, "--once", "--fleet"],
                               capture_output=True, text=True, timeout=60)
    finally:
        worker.join(600.0)
        obs.bus().detach(sink)
    wall = time.perf_counter() - t0
    check("error" not in box, f"fleet soak raised {box.get('error')!r}")
    rec = box["rec"]
    check(watch.returncode == 0 and "fleet: 2 replica(s)" in watch.stdout,
          f"slo_watch --fleet: rc {watch.returncode}: {watch.stdout[-500:]} "
          f"{watch.stderr[-500:]}")
    fl = rec["fleet"]
    respawns = [e["recovery_s"] for e in sink.events if e["kind"] == "fabric_respawn"]
    check(set(rec) == FLEET_RECORD_KEYS, f"fleet record keys {sorted(set(rec) ^ FLEET_RECORD_KEYS)}")
    check(rec["recovery"]["losses_injected"] == 1 and respawns,
          f"fleet soak recovery {rec['recovery']}, respawns {respawns}")
    check(fl["respawns"] >= 1 and fl["rolled"] == 2 and fl["roll"]["ok"] and fl["floor"] >= 1,
          f"fleet soak record {fl}")
    check(rec["dropped"] == 0 and rec["double_served"] == 0 and rec["backend"] == FLEET_BACKEND,
          f"fleet soak dropped {rec['dropped']}, served twice {rec['double_served']}, "
          f"backend {rec['backend']}")
    # the reference's bar (tests/test_fabric.py:554), and no roll retried
    check(rec["recovery"]["time_to_recover_s"] is not None,
          f"fleet soak recovery {rec['recovery']}: no time to recover")
    check(fl["roll_retries"] == 0, f"fleet soak roll retries {fl['roll_retries']}")
    print(f"fleet 17g fleet soak ({card_label}): {wall:.1f} s wall, {rec['requests']} "
          f"requests at {rec['qps']} queries/s, served p50 {rec['served_p50_ms']} ms p99 "
          f"{rec['served_p99_ms']} ms, time to recover {rec['recovery']['time_to_recover_s']} "
          f"s (the soak's, read between its ticks; the supervisor's respawns took "
          f"{respawns} s from detection to ready), respawns {fl['respawns']}, rolled "
          f"{fl['rolled']} in {fl['roll']['roll_s']} s, "
          f"floor {fl['floor']}, retries {fl['retries']}, roll retries {fl['roll_retries']}, "
          f"cache {rec['cache']}")
    print("fleet 17g slo_watch --once --fleet: " + " | ".join(
        line.strip() for line in watch.stdout.strip().splitlines()[:4]))


def fleet_phase(wiki, reset_counts, counts, card_label: str) -> dict:
    """Phase 17 (see the module docstring); every check raises on failure.
    Returns the kernels' launches in 17f and 17g (the soak's prior)."""
    import threading

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs, serving
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.tfidf import run_tfidf
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import fabric
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.serving import segments as sgm
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import config as tcfg

    # the replicas' contexts share the card with this process: hand its
    # cached blocks back first
    torch.cuda.empty_cache()
    # replicas run `python -m` from wherever this script was started
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    cfg = tcfg.TfidfConfig(vocab_bits=TFIDF_BITS, ngram=2, idf_mode="smooth",
                           l2_normalize=True)
    queries = serving_queries(wiki, SERVE_QUERIES, SERVE_SEED)
    sink = obs.MemorySink()
    obs.bus().attach(sink)
    with tempfile.TemporaryDirectory() as tmp:
        seg_dir = os.path.join(tmp, "fleet")
        seal = seal_fleet_index(seg_dir, wiki, cfg, FLEET_DEVICE, SEGMENTS)
        gen = sgm.manifest_version(seg_dir)
        # 17a: two replica processes on the card
        used0 = card_used_mib()
        t0 = time.perf_counter()
        fab = fabric.ServingFabric(seg_dir, fabric.FabricConfig(
            replicas=FLEET_REPLICAS, device=FLEET_DEVICE, top_k=QUERY_K, poll_s=0.2,
            health_period_s=0.25, retry_pause_s=0.05, request_timeout_s=60.0,
            grace_s=30.0, ready_timeout_s=300.0,
            replica_chaos=((FLEET_REPLICAS, f"replica_query:proc_kill@{FLEET_KILL_AT}"),)))
        cli = None
        try:
            fab.start()
            start = time.perf_counter() - t0
            shakes = fleet_spawn_times(sink.events)
            pids = {i: h.pid for i, h in fab._handles.items()}
            used = card_used_mib()
            holders = card_holders()
            check(set(pids.values()) <= holders,
                  f"replica pids {pids} do not hold the card (holders {holders}; their "
                  f"device files {[dev_files(p) for p in pids.values()]})")
            print(f"fleet 17a ({card_label}): {SEGMENTS} config-5 segments sealed in "
                  f"{seal:.1f} s (generation {gen}); {FLEET_REPLICAS} replicas up in "
                  f"{start:.1f} s, handshakes " + ", ".join(f"{s:.2f} s" for s in shakes)
                  + f"; replica pids {sorted(pids.values())} hold the card's device file; the "
                  f"card's "
                  f"used memory {used0} -> {used} MiB, {(used - used0) / FLEET_REPLICAS:.0f} "
                  f"MiB a replica; nvidia-smi compute apps: {compute_apps()}")

            # 17b: the queries through the router, against the in-process server
            t0 = time.perf_counter()
            with serving.TfidfServer(sgm.load_segment_set(seg_dir),
                                     serving.ServeConfig(top_k=QUERY_K),
                                     device=FLEET_DEVICE) as ref_srv:
                want = serve_all(ref_srv, queries, "tfidf")
            ref_s = time.perf_counter() - t0
            got, lat, wall = fleet_loop(lambda q: fab.query(q), queries, FLEET_CLIENTS)
            same = check_fleet_answers(got, want, "fleet 17b")
            audit = fab.audit()
            check(audit["delivered"] == len(queries) and audit["dropped"] == 0
                  and audit["double_served"] == 0, f"fleet 17b audit {audit}")
            # each replica's own serve time (its /status window), the rest of
            # a query's latency is the router's HTTP hop
            split = {s["replica"]: (s["executions"], s["p50_ms"], s["p99_ms"])
                     for s in fab.statuses()}
            port0 = fab._ports[0]
            before = fab.statuses()[0]
            dup = [fleet_post(port0, "/query", {"rid": "smoke-dup", "terms": queries[0],
                                                 "ranker": "tfidf"}) for _ in range(2)]
            after = fab.statuses()[0]
            check(dup[0][0] == 200 and dup[0][2] == dup[1][2]
                  and after["executions"] - before["executions"] == 1
                  and after["replays"] - before["replays"] == 1,
                  f"a repeated rid was not replayed: {before} -> {after}")
            print(f"fleet 17b ({card_label}): {len(queries)} queries, {FLEET_CLIENTS} "
                  f"closed-loop clients through the router: {len(queries) / wall:.1f} "
                  f"queries/s, p50 {pct_ms(lat, 50):.2f} ms, p99 {pct_ms(lat, 99):.2f} ms; "
                  f"by replica (executions, own p50 / p99 ms of the last 512) {split}; "
                  f"within 11c's bar of the in-process "
                  f"server ({ref_s:.1f} s for the reference pass), {same} of {len(queries)} "
                  f"equal bit for bit; a repeated rid replayed byte-equal, not executed; "
                  f"audit {audit}")

            # 17h: the fabric's CLI on the card, its answers against 17b's
            used_before = card_used_mib()
            cli, cli_s = cli_replica(seg_dir)
            cli_mib = card_used_mib() - used_before
            check(cli.pid in card_holders(), "the CLI replica does not hold the card")
            cport = int(cli.ready["port"])
            cli_got = []
            for k, q in enumerate(queries[:FLEET_CLI_QUERIES]):
                code, doc, _ = fleet_post(cport, "/query", {"rid": f"cli-{k}", "terms": q})
                check(code == 200, f"CLI replica answered {code}: {doc}")
                cli_got.append((np.asarray(doc["scores"], np.float32),
                                np.asarray(doc["docs"], np.int32)))
            check(all(a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
                      for a, b in zip(cli_got, got)), "the CLI replica's answers differ from 17b's")
            rc = cli.terminate(60.0)
            check(rc == 0, f"CLI replica exited {rc} on SIGTERM")
            cli = None
            print(f"fleet 17h: python -m {FLEET_MODULE} --replica --device {FLEET_DEVICE}, handshake "
                  f"{cli_s:.2f} s (generation {gen}), {cli_mib} MiB of the card, "
                  f"{FLEET_CLI_QUERIES} answers equal to 17b's bit for bit, SIGTERM rc 0")

            # 17c: a replica whose environment kills it at its third query
            deg0 = len(sink.of_kind("degraded"))
            used_before = card_used_mib()
            t0 = time.perf_counter()
            added = fab.scale_up(1)
            up_s = time.perf_counter() - t0
            up_mib = card_used_mib() - used_before
            check(added == [FLEET_REPLICAS], f"scale_up added {added}")
            victim = added[0]
            owned = [k for k, q in enumerate(queries)
                     if fab._ring.route(fabric.affinity_key(q, "tfidf"))[0] == victim]
            pick = sorted(set(owned[:24]) | set(range(24)))
            victim_pid = fab._handles[victim].pid
            t_kill = time.perf_counter()
            res, lat_c, _ = fleet_loop(lambda k: fab.query(queries[k]), pick, FLEET_CLIENTS)
            check(all(a[0].tobytes() == got[k][0].tobytes() and a[1].tobytes()
                      == got[k][1].tobytes() for a, k in zip(res, pick)),
                  "answers across the kill differ from 17b's")
            deadline = time.monotonic() + 300.0
            while time.monotonic() < deadline:
                sts = fab.statuses()
                if (fab.audit()["respawns"] >= 1 and all(s is not None and s.get("ready")
                                                         for s in sts)):
                    break
                time.sleep(0.2)
            respawn_ev = sink.of_kind("fabric_respawn")
            deg = sink.of_kind("degraded")[deg0:]
            audit = fab.audit()
            check(len(deg) == 1 and deg[0]["ladder"] == "respawn"
                  and deg[0]["replica"] == victim and deg[0]["pid"] == victim_pid,
                  f"17c degraded events {deg}")
            check(audit["respawns"] == 1 and len(respawn_ev) == 1
                  and audit["dropped"] == 0 and audit["double_served"] == 0,
                  f"17c audit {audit}, respawns {respawn_ev}")
            new_pid = fab._handles[victim].pid
            check(new_pid != victim_pid and new_pid in card_holders()
                  and victim_pid not in card_holders(),
                  f"respawned replica {new_pid} not on the card, or {victim_pid} still is")
            recovery_s = respawn_ev[0]["recovery_s"]
            removed = fab.scale_down(1)
            check(removed == [victim], f"scale_down removed {removed}")
            print(f"fleet 17c ({card_label}): scale_up to 3 in {up_s:.2f} s ({up_mib} MiB of "
                  f"the card); "
                  f"replica_query:proc_kill@{FLEET_KILL_AT} killed replica {victim} (pid "
                  f"{victim_pid}) mid-query; {len(pick)} queries answered equal to 17b's "
                  f"(p99 {pct_ms(lat_c, 99):.1f} ms), one degraded on the respawn rung, "
                  f"respawned (pid {new_pid}) ready in {recovery_s} s from the kill's "
                  f"detection ({time.perf_counter() - t_kill:.1f} s wall); retries "
                  f"{audit['retries']}, dropped 0, served twice 0; scale_down back to 2")

            # 17e: the peer cache on the processes, then its faults in-process
            ring = fab._ring
            q_peer = next(q for q in queries[FLEET_CLI_QUERIES:]
                          if ring.route(fabric.affinity_key(q, "tfidf"))[0] == 0)
            code_o, owner_doc, _ = fleet_post(fab._ports[0], "/query",
                                              {"rid": "peer-owner", "terms": q_peer})
            hits = fab.statuses()[1]["peer_hits"]
            code_n, peer_doc, _ = fleet_post(fab._ports[1], "/query",
                                             {"rid": "peer-nonowner", "terms": q_peer})
            hits2 = fab.statuses()[1]["peer_hits"]
            check(code_o == code_n == 200 and hits2 == hits + 1
                  and json.dumps(peer_doc["scores"]) == json.dumps(owner_doc["scores"])
                  and json.dumps(peer_doc["docs"]) == json.dumps(owner_doc["docs"]),
                  f"17e: non-owner's answer {peer_doc} vs owner's {owner_doc}, peer hits "
                  f"{hits} -> {hits2}")
            print("fleet 17e: a non-owner's miss served by the owner's cache, byte for byte "
                  "equal to the owner's answer (peer hits +1)")
            peer_pair_phase(seg_dir, queries, card_label)

            # 17d: a rolling restart with handoff under load, then the floor
            stop = threading.Event()
            failures, served = [], [0]
            samples: list = []

            def hammer(c: int) -> None:
                k = c
                while not stop.is_set():
                    try:
                        fab.query(queries[k % len(queries)])
                        served[0] += 1
                    except Exception as exc:  # noqa: BLE001 — checked below
                        failures.append(exc)
                    k += FLEET_CLIENTS

            def sample() -> None:
                while not stop.is_set():
                    samples.append((len(card_holders()), card_used_mib()))
                    stop.wait(0.25)

            ports_before = dict(fab._ports)
            pids_before = {i: h.pid for i, h in fab._handles.items()}
            threads = [threading.Thread(target=hammer, args=(c,), name=f"smoke-client-{c}")
                       for c in range(FLEET_CLIENTS)] + [
                threading.Thread(target=sample, name="smoke-sample")]
            for t in threads:
                t.start()
            try:
                t0 = time.perf_counter()
                fab.rolling_restart(timeout=300.0)
                roll_s = time.perf_counter() - t0
            finally:
                stop.set()
                for t in threads:
                    t.join(120.0)
            audit = fab.audit()
            check(not failures, f"17d: queries failed during the roll: {failures[:3]}")
            check(audit["roll_retries"] == 0 and audit["rolled"] == 2
                  and audit["dropped"] == 0 and audit["double_served"] == 0,
                  f"17d audit {audit}; suspects "
                  f"{[(e['replica'], e['error']) for e in sink.of_kind('fabric_suspect')]}")
            check(fabric.read_floor(seg_dir) == gen, f"floor {fabric.read_floor(seg_dir)}")
            check(dict(fab._ports) == ports_before
                  and all(fab._handles[i].pid != p for i, p in pids_before.items()),
                  "the roll did not keep the ports or replace the processes")
            print(f"fleet 17d ({card_label}): rolling restart with handoff under "
                  f"{FLEET_CLIENTS} clients in {roll_s:.1f} s, {served[0]} queries served "
                  f"meanwhile, roll retries 0, rolled 2, floor {gen}; at most "
                  f"{max(n for n, _ in samples)} replica processes on the card at once, the "
                  f"card's used memory {min(m for _, m in samples)}-"
                  f"{max(m for _, m in samples)} MiB over {len(samples)} samples")
            fabric.commit_floor(seg_dir, gen + 1)
            cli, cli_s = cli_replica(seg_dir)
            cport = int(cli.ready["port"])
            check(cli.ready["generation"] is None and healthz(cport) == 503,
                  f"a replica restarted under floor {gen + 1}: {cli.ready}, healthz "
                  f"{healthz(cport)}")
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline and any(healthz(p) != 503
                                                      for p in fab._ports.values()):
                time.sleep(0.1)
            check(all(healthz(p) == 503 for p in fab._ports.values()),
                  "fleet replicas still healthy under a floor above their generation")
            t0 = time.perf_counter()
            extra = run_tfidf(wiki[:2_000], cfg, device=FLEET_DEVICE)
            end = max(r.doc_base + r.n_docs for r in sgm.latest_manifest(seg_dir).segments)
            sgm.commit_append(seg_dir, sgm.seal_segment(
                seg_dir, extra, cfg, doc_base=end, bm25=tcfg.Bm25Config()),
                cfg.config_hash())
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline and healthz(cport) != 200:
                time.sleep(0.1)
            catch = time.perf_counter() - t0
            check(healthz(cport) == 200, "the restarted replica never caught up")
            check(fab.await_fleet_generation(gen + 1, timeout=120.0),
                  "the fleet never reached the new generation")
            code, doc, _ = fleet_post(cport, "/query", {"rid": "floor-1", "terms": queries[1]})
            check(code == 200 and doc["generation"] == gen + 1, f"after the floor: {doc}")
            check(cli.terminate(60.0) == 0, "CLI replica did not exit 0")
            cli = None
            print(f"fleet 17d floor: committed {gen + 1} above the fleet's {gen}: a replica "
                  f"restarted then (handshake {cli_s:.2f} s, generation None) and the "
                  f"fleet's replicas answered /healthz 503; generation {gen + 1} committed, "
                  f"served after {catch:.2f} s")
        finally:
            if cli is not None:
                cli.kill()
            fab.stop()
            obs.bus().detach(sink)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and card_holders():
            time.sleep(0.5)
        check(not card_holders(),
              f"replica processes left on the card after the fleet stopped: {card_holders()}")
    launched = soak_phase(reset_counts, counts, card_label)
    fleet_soak_phase(card_label)
    return launched


# Phase 18: the analyzer's ported tiers, each with the enumeration it prints
# (--lock-graph, --crash-points, --wire-probes), one process a tier; and the
# protocol harness's per-exchange HTTP timeout (a hit is a hang: a failure).
ANALYSIS_TIERS = (("1", ()), ("2", ()), ("3", ("--cost-report",)), ("4", ("--lock-graph",)),
                  ("5", ("--crash-points",)), ("6", ("--wire-probes",)))
# 18c: the registry's main-path entries and the SpMV impl of each (None:
# the hybrid head's row sums alone, at that run's head rows).
MAIN_ENTRIES = (("pagerank_step", "segment"), ("pagerank_step_pallas", "pallas"),
                ("pagerank_step_hybrid", "hybrid"),
                ("pagerank_step_sort_shuffle", "sort_shuffle"),
                ("pagerank_rowsum_pallas", None))
ANALYSIS_TIMEOUT_S, HARNESS_TIMEOUT_S = 300.0, 10.0


def traced_entry(name: str, fn, args: tuple, reset_counts, counts, card_label: str) -> dict:
    """18c for one entry: ``fn(*args)`` traced on fake tensors of its
    arguments' shapes, then one real step (``fixpoint.single_step``), whose
    launches of each kernel must equal its op nodes in the trace; where the
    trace counted no host read, the step again under
    ``set_sync_debug_mode("error")``, which raises on any sync; the
    modelled bytes and FLOPs a step (tier 3's model) printed beside the
    step's device ms (CUDA events).  Returns the real step's launches."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import cost
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis import trace as tr
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.dataflow import fixpoint

    def step():
        with fixpoint.single_step():
            return fn(*args)

    t0 = time.perf_counter()
    trace = tr.trace_variant(fn, tr.spec_of(args))
    trace_s = time.perf_counter() - t0
    nodes = trace.kernel_nodes()
    model = cost.summarize(trace)
    step()  # warm-up: the kernels' libraries load
    torch.cuda.synchronize()
    reset_counts()
    step()
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    check(launched == nodes, f"18c {name}: one step launched {launched}, the trace has "
                             f"{nodes} kernel op nodes")
    reads = trace.transfers()
    if not reads:
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    ms = time_ms(step)
    b, by = bound_ms(model.hbm_bytes, model.flops)
    print(f"18c {name} ({card_label}): traced in {trace_s:.2f} s, {len(trace.nodes)} ops, "
          f"kernel op nodes {nodes} == one step's launches {launched}; host reads "
          f"{len(reads)}" + ("" if reads else ", no sync under sync_debug_mode('error')")
          + f"; modelled {model.hbm_bytes} bytes, {model.flops} FLOPs a step (intensity "
          f"{model.intensity:.4f}, bound {b:.4f} ms by {by}); measured {ms:.4f} ms a step")
    return launched


def traced_entries_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """18c: each main-path entry of the registry at the stand-in's shape on
    cuda:0 (``traced_entry``): the runner of each main impl over its
    ``put_graph_for`` graph, and the row sums alone at the ``hybrid``
    head's rows.  Returns the kernels' launches over the real steps."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis.registry import ENTRY_POINTS
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import put_graph_for
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import PageRankConfig

    registered = {ep.name for ep in ENTRY_POINTS}
    total: dict = {}
    head_rows = None
    for name, impl in MAIN_ENTRIES:
        check(name in registered, f"18c: {name} is not a registered entry")
        if impl is None:
            fn, args = pk.rowsum_kernel, (head_rows,)
        else:
            cfg = PageRankConfig(iterations=ITERS, dangling="redistribute", init="uniform",
                                 spmv_impl=impl)
            dg = put_graph_for(graph, cfg, "cuda")
            e = torch.from_numpy(ops.restart_vector(graph.n_nodes, cfg)).to("cuda")
            r0 = torch.from_numpy(ops.init_ranks(graph.n_nodes, cfg)).to("cuda")
            fn, args = ops.make_pagerank_runner(graph.n_nodes, cfg), (dg, r0, e)
            if impl == "hybrid":  # the head's gathered rows at uniform ranks
                w = dg.inv_outdeg / graph.n_nodes
                head_rows = torch.cat([w, w.new_zeros(1)])[dg.hybrid.head_src]
        add_counts(total, traced_entry(name, fn, args, reset_counts, counts, card_label))
    return total


def analysis_phase(graph, reset_counts, counts, card_label: str) -> dict:
    """18a: the port's analyzer over the tree as shipped, one process a
    tier, all started together: each exits 0 with no finding under the
    empty baseline; prints each tier's findings, what its enumeration or
    report holds and its seconds.  18b: the protocol harness with its
    replica and the router on cuda:0: every probe conforms, the duplicate
    rid leaves ``executions`` unmoved, ``double_served == 0``, the stale
    floor ends in ``FabricExhausted``.  18c: ``traced_entries_phase``.
    Returns the kernels' launches over 18b (none: no kernel is on the
    harness's path) and 18c."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import protocol_harness

    procs, secs, outs, files = {}, {}, {}, {}
    t0 = time.perf_counter()
    try:
        for tier, flags in ANALYSIS_TIERS:
            # each tier writes to files: a report larger than a pipe's buffer
            # would block its writer until the reader came
            files[tier] = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            procs[tier] = subprocess.Popen(
                [sys.executable, "-m", "page_rank_and_tfidf_using_apache_spark_tpu_torch.analysis",
                 "--tier", tier, *flags, "--json"], cwd=ROOT, stdout=files[tier][0],
                stderr=files[tier][1], text=True)
        # each tier's own wall time: poll them all, read each once it ends
        while len(outs) < len(procs):
            check(time.perf_counter() - t0 < ANALYSIS_TIMEOUT_S,
                  f"18a: tiers {sorted(set(procs) - set(outs))} still running")
            for tier, proc in procs.items():
                if tier not in outs and proc.poll() is not None:
                    secs[tier] = time.perf_counter() - t0
                    outs[tier] = tuple(f.seek(0) or f.read() for f in files[tier])
            time.sleep(0.02)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for pair in files.values():
            for f in pair:
                f.close()
    for tier, proc in procs.items():
        out, err = outs[tier]
        check(proc.returncode == 0,
              f"18a tier {tier}: exit {proc.returncode}: {out[-2000:]} {err[-2000:]}")
        doc = json.loads(out)
        check(doc["ok"] is True and doc["findings"] == [] and doc["tiers"] == [int(tier)],
              f"18a tier {tier}: {doc['findings']}")
        lock_graph = doc.get("lock_graph", {})
        report = doc.get("cost_report", {})
        held = {"1": "", "2": "",
                "3": f"; {len(report.get('entries', []))} entries costed, intensity gate "
                     f"{report.get('intensity_gate')}, {len(doc.get('advisories', []))} "
                     "advisories",
                "4": f"; lock graph: {len(lock_graph.get('nodes', {}))} locks, "
                     f"{len(lock_graph.get('edges', []))} edges, "
                     f"{len(lock_graph.get('threads', []))} threads",
                "5": f"; {sum(len(v or []) for v in doc.get('crash_points', {}).values())} "
                     f"crash points over {len(doc.get('crash_points', {}))} commit sequences",
                "6": f"; {len(doc.get('wire_probes', []))} wire probes"}[tier]
        print(f"18a analysis tier {tier}: exit 0, {len(doc['findings'])} findings "
              f"({doc['known']} baselined){held}; {secs[tier]:.2f} s")
    print(f"18a analysis: tiers {', '.join(procs)} clean in {max(secs.values()):.2f} s "
          "(started together)")

    reset_counts()
    t1 = time.perf_counter()
    report = protocol_harness.run_harness(timeout_s=HARNESS_TIMEOUT_S, device="cuda:0")
    harness_s = time.perf_counter() - t1
    launched = counts()
    check("fatal" not in report, f"18b protocol harness: {report.get('fatal')}")
    check(report["ok"], f"18b protocol harness violations: {report['violations']}")
    check(report["device"] == "cuda:0", f"18b replica on {report['device']}")
    check(report["duplicate_executions"] == 0,
          f"18b duplicate rid moved executions by {report['duplicate_executions']}")
    check(report["double_served"] == 0, f"18b double_served {report['double_served']}")
    check(report["router_refusal"] == "FabricExhausted",
          f"18b stale floor ended in {report['router_refusal']}")
    print(f"18b protocol harness ({card_label}): {report['probes']} probes, "
          f"{report['replica_checks']} replica checks, {report['router_checks']} router "
          f"check against contract {report['fingerprint']}, replica and router on "
          f"{report['device']}; handshake {report['handshake_s']:.2f} s, harness "
          f"{harness_s:.2f} s; duplicate rid executions +{report['duplicate_executions']}, "
          f"double_served {report['double_served']}, stale floor -> "
          f"{report['router_refusal']}; kernel launches {launched}")
    launched = dict(launched)
    add_counts(launched, traced_entries_phase(graph, reset_counts, counts, card_label))
    return launched


# ------------------------------------------------------------- phase 19
# the port's CI and chaos gates on the card: every scenario of
# tools/chaos_scenarios.py but the crash harness's, whose workers touch no
# device, and the smokes of tools/ci_smokes.py that run a device path

CI_SCENARIOS = ("device_lost", "fixpoint", "ingest_h2d", "segment_swap", "malformed",
                "fed_scrape", "cache_peer")
CI_SMOKES = ("owned", "segment")


def ci_phase(reset_counts, counts, card_label: str) -> dict:
    """19a: each scenario of ``CI_SCENARIOS`` on ``cuda:0`` (mesh slots of
    the card, replicas on the card), holding the reference's bars (the
    scenario asserts them) and printing its records and seconds.  19b: the
    ``CI_SMOKES`` on the card within the reference's budgets.  Returns the
    kernels' launches over the phase; the sharded runners' segmented sums
    launch ``segment``."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import chaos_scenarios as cs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import ci_smokes

    reset_counts()
    secs = {}
    for name in CI_SCENARIOS:
        t0 = time.perf_counter()
        try:
            rep = cs.SCENARIOS[name]("cuda:0")
        except AssertionError as exc:  # a bar the scenario holds
            raise RuntimeError(f"chip_smoke check failed: 19a {name}: {exc}") from exc
        secs[name] = time.perf_counter() - t0
        held = {k: rep[k] for k in ("mesh_shrinks", "exhausted", "degraded", "audit",
                                    "max_abs_err", "blocking_s", "typed_rejections",
                                    "requests") if k in rep}
        print(f"19a {name} ({card_label}): {rep['line']}; {held}; {secs[name]:.2f} s")
    for name in CI_SMOKES:
        t0 = time.perf_counter()
        try:
            rep = ci_smokes.SMOKES[name]("cuda:0")
        except AssertionError as exc:  # a bar the scenario holds
            raise RuntimeError(f"chip_smoke check failed: 19b {name}: {exc}") from exc
        secs[name] = time.perf_counter() - t0
        print(f"19b {name} smoke ({card_label}): {rep['line']}; {secs[name]:.2f} s of its "
              f"{rep['budget_s']:g} s budget")
    launched = counts()
    check(launched.get("segment", 0) > 0, f"19: the sharded runners launched no segment: "
          f"{launched}")
    print(f"19 ci: {len(CI_SCENARIOS)} scenarios and {len(CI_SMOKES)} smokes held in "
          f"{sum(secs.values()):.1f} s; kernel launches {launched}")
    return launched


# Phase 20: the reference's dry run on 4 slots with its full owned-scale
# sweep at its own knobs' defaults, the 1,000,000-document rehearsal at the
# tool's defaults, and the port's three examples.
DRYRUN_SLOTS = 4
SWEEP_KNOBS = {"BENCH_OWNED_SCALES": "1,4,10", "BENCH_OWNED_BASE_NODES": "875000",
               "BENCH_OWNED_AVG_DEG": "5.83", "BENCH_OWNED_HBM_BYTES": str(256 << 20)}
EXAMPLES = ("torch_pagerank_example.py", "torch_tfidf_example.py",
            "torch_multichip_example.py")
EXAMPLE_L1 = 1e-9
REHEARSAL_MODULE = "page_rank_and_tfidf_using_apache_spark_tpu_torch.tools.streaming_rehearsal"
# 20a's graphs are built by one process started ahead of the phase (the
# host's Zipf build at 10x takes minutes; the sweep's own generator, each
# graph pickled with its build seconds as it completes), at the lowest
# priority, so the phases it overlaps keep their cores
SWEEP_BUILDER = """
import os, pickle, sys, time
os.nice(19)
from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import dryrun
for _, n, e in dryrun.sweep_points():
    t0 = time.perf_counter()
    g = dryrun.sweep_graph(n, e)
    path = os.path.join(sys.argv[1], f"{n}_{e}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump((g, time.perf_counter() - t0), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)
"""
SWEEP_BUILD_DEADLINE_S = 1200.0


class SweepGraphs:
    """The owned-scale sweep's graphs, built in one background process
    (``SWEEP_BUILDER``, under ``SWEEP_KNOBS``) while the earlier phases run,
    each handed to 20a with its build seconds.  The process and its
    directory go at exit."""

    def __init__(self) -> None:
        self.dir = tempfile.mkdtemp(prefix="sweep_graphs_")
        self.started = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-c", SWEEP_BUILDER, self.dir], cwd=ROOT,
                                     env={**os.environ, **SWEEP_KNOBS})
        atexit.register(self.stop)

    def graph_at(self, n: int, e: int) -> tuple:
        """``(graph, build seconds)`` of one point, waiting for its build."""
        path = os.path.join(self.dir, f"{n}_{e}.pkl")
        while not os.path.exists(path):
            done = self.proc.poll() is not None
            check(not (done and not os.path.exists(path)),
                  f"20a: the graph builder exited {self.proc.returncode} before n={n}")
            check(time.perf_counter() - self.started < SWEEP_BUILD_DEADLINE_S,
                  f"20a: n={n} not built within {SWEEP_BUILD_DEADLINE_S:g} s")
            time.sleep(0.5)
        with open(path, "rb") as f:
            g, secs = pickle.load(f)
        os.remove(path)
        return g, secs

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def dryrun_phase(card_label: str, graphs: SweepGraphs) -> None:
    """20a: ``tools/dryrun.dryrun_multichip(4)`` on the card (4 slots of
    cuda:0 on one card, one slot a card on four) with the 1x/4x/10x sweep
    over ``graphs``' builds:
    every strategy and the sharded TF-IDF finite, each point's float32
    ``owned`` equal to one device bit for bit and its float64 within 1e-9
    L1, the comm-bytes exponent below 1, ``auto_select_strategy`` ->
    ``owned`` at 10x (the tool raises where one does not hold); each
    point's record printed, with the bytes its float64 head psum moves."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import chaos_scenarios as cs
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import dryrun

    t0 = time.perf_counter()
    with cs.env(**SWEEP_KNOBS):
        try:
            rec = dryrun.dryrun_multichip(DRYRUN_SLOTS, graph_at=graphs.graph_at)
        except AssertionError as exc:  # a bar the dry run holds
            raise RuntimeError(f"chip_smoke check failed: 20a: {exc}") from exc
    sweep = rec["owned_scale"]
    check(sweep is not None and [p["scale"] for p in sweep["points"]] == [1.0, 4.0, 10.0],
          f"20a: the sweep ran {sweep and [p['scale'] for p in sweep['points']]}")
    check(sweep["auto_select"] == "owned" and sweep["comm_bytes_exponent"] < 1.0,
          f"20a: {sweep}")
    for p in sweep["points"]:
        print(f"20a owned-scale point ({card_label}; {rec['layout']}): {json.dumps(p)}")
    print(f"20a dry run ({card_label}; {rec['layout']}): 7 strategies and sharded TF-IDF "
          f"(nnz {rec['tfidf']['nnz']}) ok; comm-bytes exponent "
          f"{sweep['comm_bytes_exponent']:.3f}, top scale replicated state "
          f"{sweep['top_replicated_state_bytes']} B against half of "
          f"{sweep['budget_bytes']} B, auto_select -> {sweep['auto_select']}; "
          f"{time.perf_counter() - t0:.1f} s")


def rehearsal_phase(card_label: str) -> None:
    """20b: ``tools/streaming_rehearsal.py`` at its defaults (1,000,000
    documents, bigrams, a checkpoint every 32 chunks) on the card, as its
    own process (its peak RSS is its own) writing into a temporary
    directory: ``n_docs`` 1,000,000, ``n_tokens`` equal to the generator's
    corpus counted on the host, the reference's checkpoint count for the
    chunk count, and the 1/8-scale serial and pipelined runs equal bit for
    bit (the tool exits 1 where they are not)."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import streaming_rehearsal as sr

    args = sr.build_parser().parse_args([])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rehearsal.json")
        run = subprocess.run([sys.executable, "-m", REHEARSAL_MODULE,
                              "--device", "cuda", "--out", out], cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        check(run.returncode == 0, f"20b: the rehearsal exited {run.returncode}: "
                                   f"{run.stderr[-3000:]}")
        with open(out) as f:
            rec = json.load(f)
    secs = time.perf_counter() - t0
    want_tokens = sr.corpus_tokens(args.docs, args.docs_per_chunk, args.tokens_per_doc,
                                   args.seed, args.ngram)
    # the reference's rule: a checkpoint each checkpoint_every chunks while
    # chunks remain (the end's commit writes none): 3 at 123 chunks
    chunks = -(-args.docs // args.docs_per_chunk)
    want_ckpts = (chunks - 1) // args.checkpoint_every
    print(f"20b rehearsal ({card_label}): {json.dumps(rec)}")
    check(rec["backend"] == "gpu" and rec["n_docs"] == args.docs,
          f"20b: backend {rec['backend']}, {rec['n_docs']} documents")
    check(rec["n_tokens"] == want_tokens,
          f"20b: {rec['n_tokens']} tokens, the generator's corpus holds {want_tokens}")
    check(rec["checkpoints_written"] == want_ckpts,
          f"20b: {rec['checkpoints_written']} checkpoints over {chunks} chunks, "
          f"wanted {want_ckpts}")
    print(f"20b rehearsal ({card_label}): {rec['n_docs']} documents, {rec['n_tokens']} tokens "
          f"(the host's count), {rec['tokens_per_sec']} tokens/s "
          f"({rec['tokens_per_sec_ingest']} ingest), ingest {rec['ingest_secs']} s, finalize "
          f"{rec['finalize_secs']} s, peak RSS {rec['peak_rss_mb']} MB, "
          f"{rec['checkpoints_written']} checkpoints over {chunks} chunks, 1/8-scale serial "
          f"and pipelined equal bit for bit, pipeline speedup "
          f"{rec['pipeline_speedup_vs_serial']}; {secs:.1f} s with the process")


def examples_phase(card_label: str) -> None:
    """20c: the port's three examples as processes on the card, started
    together, each exiting 0; the multichip example's L1 against one device
    at most 1e-9 for every strategy."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", name)],
                                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name in EXAMPLES}
    try:
        outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    for name, (out, err) in outs.items():
        rc = procs[name].returncode
        check(rc == 0, f"20c {name} exited {rc}: {err[-3000:]}")
        lines = out.strip().splitlines()
        print(f"20c {name} ({card_label}): " + " | ".join(lines))
        if name == "torch_multichip_example.py":
            l1 = [float(ln.rsplit(" ", 1)[1]) for ln in lines if "L1 vs single-chip" in ln]
            check(len(l1) == 6 and max(l1) <= EXAMPLE_L1,
                  f"20c {name}: L1 against one device {l1}, bar {EXAMPLE_L1:g}")
        else:
            check(len(lines) >= 4, f"20c {name}: printed {lines}")
    print(f"20c examples: {secs:.1f} s, the three together")


def drivers_phase(reset_counts, counts, card_label: str, graphs: SweepGraphs) -> dict:
    """Phase 20: the reference's last drivers on the card (20a the dry run
    and the owned-scale sweep over ``graphs``, 20b the rehearsal, 20c the
    examples).
    Returns the kernels' launches in this process over 20a and 20b (the
    rehearsal reaches no kernel; the examples' processes are not counted):
    ``segment`` under every strategy's sums, ``rowsum`` under ``hybrid``."""
    reset_counts()
    dryrun_phase(card_label, graphs)
    rehearsal_phase(card_label)
    launched = counts()
    check(launched.get("segment", 0) > 0 and launched.get("rowsum", 0) > 0,
          f"20: the dry run launched {launched}, no segment or no rowsum")
    examples_phase(card_label)
    print(f"20 drivers: kernel launches {launched}")
    return launched


def analysis_main() -> int:
    """``--analysis``: phase 18 alone (the kernels built first and the
    stand-in graph generated, for 18c), a result line at the end."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    def reset_counts() -> None:
        pk.reset_launches()
        gk.reset_launches()
        sk.reset_launches()

    def counts() -> dict:
        return {**pk.LAUNCHES, **gk.LAUNCHES, **sk.LAUNCHES}

    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw

    smi = card()
    print(f"{smi['device']}, {smi['power_limit']}")
    t0 = time.perf_counter()
    _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    graph = synthetic_powerlaw(N_NODES, N_EDGES, seed=SEED)
    t0 = time.perf_counter()
    launched = analysis_phase(graph, reset_counts, counts,
                              f"{smi['device']}, {smi['power_limit']}")
    print(f"phase 18 (analysis): {time.perf_counter() - t0:.1f} s; launches {launched}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def ci_main() -> int:
    """``--ci``: phase 19 alone (the kernels built first), a result line at
    the end."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    def reset_counts() -> None:
        pk.reset_launches()
        gk.reset_launches()
        sk.reset_launches()

    def counts() -> dict:
        return {**pk.LAUNCHES, **gk.LAUNCHES, **sk.LAUNCHES}

    smi = card()
    print(f"{smi['device']}, {smi['power_limit']}")
    t0 = time.perf_counter()
    _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    t0 = time.perf_counter()
    launched = ci_phase(reset_counts, counts, f"{smi['device']}, {smi['power_limit']}")
    print(f"phase 19 (ci): {time.perf_counter() - t0:.1f} s; launches {launched}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def drivers_main() -> int:
    """``--drivers``: phase 20 alone (the kernels built first), a result line
    at the end."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    def reset_counts() -> None:
        pk.reset_launches()
        gk.reset_launches()
        sk.reset_launches()

    def counts() -> dict:
        return {**pk.LAUNCHES, **gk.LAUNCHES, **sk.LAUNCHES}

    smi = card()
    print(f"{smi['device']}, {smi['power_limit']}")
    sweep_graphs = SweepGraphs()
    t0 = time.perf_counter()
    _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    t0 = time.perf_counter()
    launched = drivers_phase(reset_counts, counts, f"{smi['device']}, {smi['power_limit']}",
                             sweep_graphs)
    print(f"phase 20 (drivers): {time.perf_counter() - t0:.1f} s; launches {launched}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def fleet_main() -> int:
    """``--fleet``: phase 17 alone (the kernels built first, the config-5
    stand-in generated), a result line at the end."""
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    def reset_counts() -> None:
        pk.reset_launches()
        gk.reset_launches()
        sk.reset_launches()

    def counts() -> dict:
        return {**pk.LAUNCHES, **gk.LAUNCHES, **sk.LAUNCHES}

    smi = card()
    print(f"{smi['device']}, {smi['power_limit']}")
    t0 = time.perf_counter()
    _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    wiki = tio.synthetic_corpus_lines(WIKI_DOCS, WIKI_TOKENS, WIKI_SEED)
    t0 = time.perf_counter()
    launched = fleet_phase(wiki, reset_counts, counts, f"{smi['device']}, {smi['power_limit']}")
    print(f"phase 17 (fleet): {time.perf_counter() - t0:.1f} s; launches {launched}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def cards_main() -> int:
    """``--cards``: phase 16 alone with one slot a visible card (at least 4):
    the sharded paths across cards.  Prints the card, phase 16's lines and a
    result line with the card count."""
    global SLOT_DEVICES
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import text as tio
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk

    n = torch.cuda.device_count()
    check(n >= SHARD_SLOTS, f"--cards needs {SHARD_SLOTS} cards, {n} visible")
    SLOT_DEVICES = [f"cuda:{i}" for i in range(SHARD_SLOTS)]

    def reset_counts() -> None:
        pk.reset_launches()
        gk.reset_launches()
        sk.reset_launches()

    def counts() -> dict:
        return {**pk.LAUNCHES, **gk.LAUNCHES, **sk.LAUNCHES}

    smi = card()
    print(f"{smi['device']}, {smi['power_limit']}")
    t0 = time.perf_counter()
    _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall")
    graph = synthetic_powerlaw(N_NODES, N_EDGES, seed=SEED)
    stream = {"docs": tio.synthetic_corpus_lines(TFIDF_DOCS, TFIDF_TOKENS, TFIDF_SEED),
              "knobs": dict(vocab_bits=TFIDF_BITS, chunk_tokens=STREAM_CHUNK_TOKENS,
                            pack_target_tokens=STREAM_CHUNK_TOKENS),
              "chunk_docs": STREAM_CHUNK_DOCS}
    t0 = time.perf_counter()
    launches = sharded_phase(graph, stream, reset_counts, counts,
                             f"{smi['device']}, {smi['power_limit']}; one slot a card")
    print(f"phase 16 (mesh of {SHARD_SLOTS} cards): {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": n}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs one CUDA GPU",
              file=sys.stderr)
        return 2
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.cli import pagerank as cli
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io.graph import synthetic_powerlaw
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.models.pagerank import (
        put_graph_for,
        run_pagerank,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import gather_kernels as gk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pagerank as ops
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import pallas_kernels as pk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import put_kernels as pt
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.ops import segment_kernels as sk
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.tools import (
        gather_micro,
        spmv_breakdown,
        xla_cost_micro,
    )
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils.config import (
        SPMV_IMPLS,
        PageRankConfig,
    )

    def reset_counts() -> None:
        pk.reset_launches()
        gk.reset_launches()
        sk.reset_launches()

    def counts() -> dict:
        return {**pk.LAUNCHES, **gk.LAUNCHES, **sk.LAUNCHES}

    def plans() -> dict:
        return {**pk.PLANS_BUILT, **sk.PLANS_BUILT}

    from page_rank_and_tfidf_using_apache_spark_tpu_torch import obs

    # 14e: no phase before 14 degrades
    degraded = DegradedCount()
    obs.bus().attach(degraded)

    def no_degrade(phase: str, expected: int = 0) -> None:
        check(degraded.n == expected,
              f"after phase {phase}: {degraded.n} degraded events, wanted {expected}")

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card, as nvidia-smi --query-gpu=name,power.limit reports it
    smi = card()
    print(f"{smi['device']}, {smi['power_limit']}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # phase 20's sweep graphs, built by one process while phases 2-19 run
    sweep_graphs = SweepGraphs()

    # 2. build every kernel from csrc/, all sources at once
    t0 = time.perf_counter()
    built = _build.build(force=True)
    print(f"build: {time.perf_counter() - t0:.2f} s wall; "
          + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in built.items()))
    for name, info in built.items():
        print(f"--- nvcc {name}.cu ---\n{info['log'].strip()}", file=sys.stderr)

    t0 = time.perf_counter()
    graph = synthetic_powerlaw(N_NODES, N_EDGES, seed=SEED)
    hl = ops.build_hybrid_layout(graph)
    print(f"graph: {graph.n_nodes} nodes, {graph.n_edges} edges, hybrid head "
          f"{hl.head_src.shape[0]} rows x {hl.head_src.shape[1]} "
          f"({hl.head_edges} edges); host build {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions on the card
    # (E around the scan's tile and past its 128-tile look-back window, and
    # the length cumsum_mxu's recursive carry falls to at the main path; an
    # input one element off 16-byte alignment takes the unvectorised path)
    reset_counts()
    rng = np.random.default_rng(SEED)
    tile = _build.library("spmv").spmv_tile_len()
    mxu_base = graph.n_edges
    while mxu_base > 4 * 128:  # cumsum_blocked's default block of 128
        mxu_base = -(-mxu_base // 128)
    for dtype in (torch.float32, torch.float64):
        for e in (0, 1, 31, mxu_base, 1024, 1025, tile - 1, tile, tile + 1, 128 * tile + 1,
                  N_EDGES):
            x = torch.from_numpy(rng.standard_normal(e)).to("cuda", dtype)
            measure_cumsum(pk, x, f"E={e} {dtype}")
        x = torch.from_numpy(rng.standard_normal(N_EDGES + 1)).to("cuda", dtype)[1:]
        measure_cumsum(pk, x, f"E={N_EDGES} unaligned {dtype}")
        for w in (8, 16, 32, 64, 128):
            for r in (1, 1023, 1025, hl.head_src.shape[0]):
                rows = torch.from_numpy(rng.random((r, w))).to("cuda", dtype)
                measure_rowsum(pk, rows, f"R={r} W={w} {dtype}")
    print(f"rowsum sweep: {sweep_rowsum(pk, rng)} more shapes within tolerance")
    rowsum_yardstick(pk, rng)
    floor = time_ms(lambda: torch.cuda._sleep(0))
    print(f"launch floor: time_ms of a near-empty kernel (torch.cuda._sleep(0)) {floor:.4f} ms")

    # the main path's own inputs at uniform ranks: the hybrid tail's per-edge
    # values (the prefix sum the hybrid run launches), the head's gathered
    # rows, and all edges' values w[src] (the cumsum impl's, driven in 4d)
    inv = torch.from_numpy(graph.inv_out_strength("float32")).to("cuda")
    weighted = inv / graph.n_nodes
    src = torch.from_numpy(graph.src).to("cuda")
    per_edge = weighted[src]
    per_tail = weighted[torch.from_numpy(hl.tail_src).to("cuda")]
    w_ext = torch.cat([weighted, weighted.new_zeros(1)])
    head_rows = w_ext[torch.from_numpy(hl.head_src).to("cuda")]
    main_rows = {
        "cumsum": measure_cumsum(pk, per_tail, f"main path, hybrid tail E={per_tail.shape[0]}"),
        "rowsum": measure_rowsum(pk, head_rows, f"main path R={head_rows.shape[0]} "
                                                f"W={head_rows.shape[1]}"),
    }
    measure_cumsum(pk, per_edge, f"main path, cumsum impl E={per_edge.shape[0]}")
    indptr = torch.from_numpy(graph.csr_indptr().astype(np.int32)).to("cuda")
    small = synthetic_powerlaw(300, 1500, seed=3)
    graphs = {name: (s, ip, None) for name, (s, ip) in spmv_cases(rng, tile).items()}
    graphs["power-law 300 nodes"] = (small.src, small.csr_indptr(), None)
    graphs["main path"] = (graph.src, graph.csr_indptr(), weighted.double().cpu().numpy())
    most = sweep_spmv(pk, graphs, rng)
    print("spmv sweep, largest row / L1 difference from plain in units u of the scale "
          f"(limits {SPMV_ULPS:g} / {SPMV_L1_ULPS:g}): "
          + ", ".join(f"{str(d)[6:]} {r:.3g} / {l:.3g}" for d, (r, l) in most.items()))
    main_rows["spmv"] = measure_spmv_pallas(pk, ops, src, indptr, weighted)

    # the segment kernel: edge cases, the spmv sweep's graphs, the 300-node
    # graph and the main path's, then its three call sites' shapes
    block = _build.library("segment").segment_block_items()
    check(block == sk.BLOCK_ITEMS and tile == pk.TILE,
          f"kernel tile sizes {block}, {tile} differ from the plans' {sk.BLOCK_ITEMS}, {pk.TILE}")
    seg_graphs = dict(segment_cases(rng, block))
    seg_graphs.update({f"spmv case {k}": (ip, s) for k, (s, ip) in spmv_cases(rng, tile).items()})
    seg_graphs["power-law 300 nodes"] = (small.csr_indptr(), small.src)
    seg_graphs["main path"] = (graph.csr_indptr(), graph.src)
    most = sweep_segment(sk, seg_graphs, rng)
    print(f"segment sweep ({block} items a block), largest difference from plain as a share of "
          "its limit: " + ", ".join(f"{str(d)[6:]} {r:.3g}" for d, r in most.items()))
    main_rows["segment"] = measure_segment(sk, src, indptr, weighted,
                                           f"main path (gather) E={src.shape[0]} N={graph.n_nodes}")
    # the widened entry (float32 in, float64 out): at the main path's shape,
    # and at the owned head's of 16b's 4-slot partition (slot 0)
    widened = {"main path": measure_widened(sk, weighted, indptr, graph.n_nodes,
                                            f"main path (gather) E={src.shape[0]}", src=src)}
    lookup, hptr, h_rows, hsrc, hw = owned_head_inputs(graph, weighted, rng)
    widened["owned head"] = measure_widened(
        sk, lookup, hptr, h_rows, f"owned head, slot 0 of {SHARD_SLOTS} (gather weighted) "
                                  f"E={hsrc.shape[0]} rows={h_rows}", src=hsrc, ew=hw)
    main_rows["segment"]["widened"] = widened
    head_ptr = torch.from_numpy(ops.segment_pointers(hl.head_row_node,
                                                     hl.head_ids.shape[0])).to("cuda")
    head_sums = pk.rowsum_kernel(head_rows)
    bucket_src, bucket_node, _ = ops.build_shuffle_layout(graph)
    bucket_ptr = torch.from_numpy(ops.segment_pointers(bucket_node, graph.n_nodes)).to("cuda")
    bucket_sums = w_ext[torch.from_numpy(bucket_src).to("cuda")].sum(dim=1)
    for label, vals, ptr_t in (("hybrid head", head_sums, head_ptr),
                               ("sort_shuffle buckets", bucket_sums, bucket_ptr)):
        n_seg = ptr_t.shape[0] - 1
        plan = sk.segment_plan(ptr_t)
        err, worst = check_segment(sk, vals, ptr_t, n_seg, label, plan=plan)
        # the value loader's bound: the values and the pointers read once,
        # the sums written once
        b, by = bound_ms(vals.nbytes + ptr_t.nbytes + n_seg * vals.element_size())
        print(f"segment {label} ({vals.shape[0]} values into {n_seg} segments): kernel "
              f"{time_ms(lambda: sk.segment_sum_kernel(vals, ptr_t, n_seg, plan=plan)):.4f} ms "
              f"(without a plan {time_ms(lambda: sk.segment_sum_kernel(vals, ptr_t, n_seg)):.4f}), "
              f"plain {time_ms(lambda: sk.segment_sum_plain(vals, ptr_t, n_seg)):.4f} ms, bound "
              f"{b:.5f} ms ({by}); max abs diff {err:.3g} ({worst:.3g} of 1 ulp)")

    # 3b. the probe's gather kernel against its plain version: every mode at
    # the probe's default shapes, then one block of 8 rows, and W = 4
    probe_modes = gather_micro.modes(4_400_000)
    edge_modes = {
        "lane_w1024_steps1": gather_micro.Mode(1024, 1, 1, False),
        "sublane_w128_steps1": gather_micro.Mode(128, 1, 0, False),
        "bcast_w256_steps1": gather_micro.Mode(256, 1, 1, True),
        "lane_w4": gather_micro.Mode(4, 3, 1, False),
        "sublane_w4": gather_micro.Mode(4, 3, 0, False),
        "bcast_w4": gather_micro.Mode(4, 3, 1, True),
    }
    gather_rows = {}
    for name, mode in {**probe_modes, **edge_modes}.items():
        x, idx = (torch.from_numpy(a).to("cuda") for a in gather_micro.mode_inputs(mode, rng))
        gather_rows[name] = measure_gather(gk, mode, x, idx, f"{name} steps={mode.steps}",
                                           yardstick=name in probe_modes)
    main_rows["gather"] = gather_rows["lane_w109184"]
    sweep_gather_routes(gk, gather_micro, rng)

    # 3c. the put's derivation against its plain versions and the host
    # builders, at the 300-node graph and the main path's, timed there
    check_put(pt, pk, sk, small, "power-law 300 nodes")
    main_rows.update(measure_put(pt, pk, sk, graph,
                                 check_put(pt, pk, sk, graph, "main path")))

    no_degrade("3")

    # 4a. every impl against a dense f64 power iteration on a small graph
    want = dense_pagerank(small, ITERS)
    for impl in SPMV_IMPLS:
        got = run_pagerank(small, PageRankConfig(
            iterations=ITERS, dangling="redistribute", init="uniform",
            dtype="float64", spmv_impl=impl), device="cuda").ranks
        err = float(np.abs(got - want).max())
        print(f"small graph {impl}: max abs error {err:.3g} vs dense f64")
        check(err <= 1e-12, f"small graph {impl}: {err} > 1e-12")

    # 4b. the main path at full width
    base = dict(iterations=ITERS, dangling="redistribute", init="uniform")
    ref = run_pagerank(graph, PageRankConfig(**base, dtype="float64"), device="cuda").ranks
    launches = {}
    ranks_by_impl = {}
    loop_ms = {}
    for impl in MAIN_IMPLS:
        cfg = PageRankConfig(**base, dtype="float32", spmv_impl=impl)
        reset_counts()
        put_graph_for(graph, cfg, "cuda")
        per_graph = plans()
        run_pagerank(graph, cfg, device="cuda")  # warm-up, not counted
        reset_counts()
        pt.reset_launches()
        res = run_pagerank(graph, cfg, device="cuda")
        launched = {**counts(), **pt.LAUNCHES}
        built = plans()
        check(built == per_graph and sum(built.values()) <= 3,
              f"{impl}: the run built plans {built}, one graph's put_graph builds {per_graph}")
        ranks = res.ranks
        ranks_by_impl[impl] = ranks
        step = last_segment(res.metrics)
        put = next(r for r in res.metrics.records if r.get("event") == "put_graph")
        total = float(ranks.sum(dtype=np.float64))
        l1 = float(np.abs(ranks.astype(np.float64) - ref).sum())
        rates = [step["iters_per_sec"]] + [
            last_segment(run_pagerank(graph, cfg, device="cuda").metrics)["iters_per_sec"]
            for _ in range(4)]
        print(f"main path {impl}: {np.median(rates):.2f} iterations/s median of 5 runs "
              f"(min {min(rates):.2f}, max {max(rates):.2f}; counted run "
              f"{step['secs'] * 1e3:.2f} ms for {res.iterations}), put_graph "
              f"{put['preprocess_secs']:.2f} s, sum {total:.9f}, L1 vs f64 segment "
              f"{l1:.3g}, launches {launched}, plans built {built} (one graph's)")
        check(ranks.shape == (graph.n_nodes,) and bool(np.isfinite(ranks).all()),
              f"{impl}: ranks not finite or wrong shape")
        check(res.iterations == ITERS, f"{impl}: ran {res.iterations} iterations")
        check(abs(total - 1.0) <= 1e-3, f"{impl}: ranks sum to {total}")
        check(l1 <= 1e-3, f"{impl}: L1 {l1} vs f64 segment > 1e-3")
        launches[impl] = launched
        loop_ms[impl] = ITERS / float(np.median(rates)) * 1e3
    check(launches["pallas"]["spmv"] >= ITERS,
          f"pallas run launched spmv {launches['pallas']['spmv']} times")
    check(launches["hybrid"]["rowsum"] >= ITERS,
          f"hybrid run launched rowsum {launches['hybrid']['rowsum']} times")
    check(launches["segment"]["segment"] >= ITERS,
          f"segment run launched segment {launches['segment']['segment']} times")
    check(launches["hybrid"]["cumsum"] >= ITERS and launches["hybrid"]["segment"] >= ITERS,
          f"hybrid run launched cumsum {launches['hybrid']['cumsum']} and segment "
          f"{launches['hybrid']['segment']} times")
    # one put a run: its node vectors, and where it keeps the edge arrays
    # (segment, pallas) its dst and both plans, each derived once on the
    # card; hybrid's the segment plan of its head's pointers
    for impl in MAIN_IMPLS:
        put = {k: launches[impl][k] for k in pt.LAUNCHES}
        want = dict.fromkeys(pt.LAUNCHES, 1)
        if impl == "hybrid":
            want.update(spmv_rows=0, expand_dst=0)
        check(put == want, f"{impl} run's put launched {put}, wanted {want}")

    # 4c. where the loop's time goes: device time by kernel, and the share
    # of the unprofiled loop wall time the device was busy
    for impl in MAIN_IMPLS:
        cfg = PageRankConfig(**base, dtype="float32", spmv_impl=impl)
        dg = put_graph_for(graph, cfg, "cuda")
        e = torch.from_numpy(ops.restart_vector(graph.n_nodes, cfg)).to("cuda")
        r0 = torch.from_numpy(ops.init_ranks(graph.n_nodes, cfg)).to("cuda")
        device_ms, rows = profile_loop(ops.make_pagerank_runner(graph.n_nodes, cfg), dg, r0, e)
        ops_per_step = sum(r[2] for r in rows) / ITERS
        print(f"profile {impl}: device {device_ms:.3f} ms of a {loop_ms[impl]:.3f} ms loop "
              f"(busy {device_ms / loop_ms[impl]:.3f}), {ops_per_step:g} "
              f"device ops per step; top kernels, ms per run: "
              + "; ".join(f"{k[:60]} {t:.3f} x{c}" for k, t, c in rows[:8]))
        if impl in ONE_OP_LIMITS:  # one device op a call: no second kernel, no memset
            bad = [r[0] for r in rows if any(s in r[0] for s in RETIRED_OPS)]
            check(not bad, f"{impl} loop still runs {bad}")
            memsets = sum(r[2] for r in rows if r[0].startswith("Memset"))
            check(memsets <= ITERS + 1, f"{impl} loop runs {memsets} memsets, more than the "
                                        f"loop's own {ITERS + 1}")
            check(ops_per_step < ONE_OP_LIMITS[impl],
                  f"{impl} loop: {ops_per_step:g} device ops per step, not below "
                  f"{ONE_OP_LIMITS[impl]:g}")
        if impl == "pallas":
            bad = [r[0] for r in rows if any(s in r[0] for s in WIDENING_KERNELS)]
            check(not bad, f"pallas loop still runs {bad}")
        if impl == "segment":  # the float64 index_add_ and its atomics are gone
            bad = [r[0] for r in rows if "indexFunc" in r[0]]
            check(not bad, f"segment loop still runs {bad}")

    # 4d. two runs of every impl at full width, bit for bit
    # (bcoo is the library's sparse product: logged, not held)
    t0 = time.perf_counter()
    differ = run_twice_bits(graph)
    bad = {k: v for k, v in differ.items() if v and k[0] != "bcoo"}
    check(not bad, f"determinism: two runs differ in {bad}")
    print(f"phase 4d (two runs of every impl): {time.perf_counter() - t0:.1f} s")

    no_degrade("4")

    # 5. the CLI once, at the same scale, traced and profiled
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ranks.tsv")
        trace_dir, profile_dir = os.path.join(tmp, "trace"), os.path.join(tmp, "profile")
        rc = cli.main([f"synthetic:{N_NODES},{N_EDGES},{SEED}", str(ITERS),
                       "--spmv-impl", "pallas", "--dangling", "redistribute",
                       "--init", "uniform", "--device", "cuda", "--output", out,
                       "--trace-dir", trace_dir, "--profile-dir", profile_dir,
                       "--tuned-profile", "off"])
        check(rc == 0, f"CLI exited {rc}")
        table = np.loadtxt(out, dtype=np.float64, delimiter="\t", ndmin=2)
        check_cli_trace(trace_dir, profile_dir)
    ids, vals = table[:, 0].astype(np.int64), table[:, 1]
    rows = np.searchsorted(graph.node_ids, ids)  # original id -> row
    check(bool(np.all(graph.node_ids[np.minimum(rows, graph.n_nodes - 1)] == ids)),
          "CLI output names ids that are not in the graph")
    expect = ranks_by_impl["pallas"][rows]
    cli_err = float(np.abs(vals - expect).max())
    print(f"cli: {len(ids)} lines, sum {vals.sum():.9f}, max abs diff vs the "
          f"pallas run {cli_err:.3g}")
    check(len(ids) == graph.n_nodes and len(set(ids.tolist())) == graph.n_nodes,
          "CLI output does not list every node once")
    check(bool(np.all(np.diff(vals) <= 0)), "CLI output not in descending rank order")
    check(cli_err <= 1e-9 * float(expect.max()), "CLI ranks differ from the pallas run")

    no_degrade("5")

    # 6a. the three SpMV cost probes, in-process through their main, at
    # default sizes; each writes its record into a temporary directory
    reset_counts()
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tool, mod in (("gather_micro", gather_micro), ("xla_cost_micro", xla_cost_micro),
                          ("spmv_breakdown", spmv_breakdown)):
            out = os.path.join(tmp, f"{tool}.json")
            t0 = time.perf_counter()
            rc = mod.main(["--out", out])
            check(rc == 0, f"{tool} exited {rc}")
            with open(out) as f:
                records[tool] = json.load(f)
            print(f"{tool} ({time.perf_counter() - t0:.1f} s): {json.dumps(records[tool])}")
            check_probe(tool, records[tool])
    launches["probes"] = counts()
    print(f"probe launches {launches['probes']}")
    check(launches["probes"]["gather"] > 0, "the probes launched no gather kernel")
    check(launches["probes"]["rowsum"] > 0, "the breakdown launched no rowsum kernel")

    # 6b. which kernels the gather_w_src stage (w[src]) runs, per call
    stage = spmv_breakdown.stages(graph, torch.device("cuda"))["gather_w_src"]
    calls = 20
    prof = profile_calls(stage.fn, calls)
    check(any(kind == "cuda" for *_, kind in prof), "profile of gather_w_src has no kernel")
    print(f"profile gather_w_src, per call (of {calls}): "
          + "; ".join(f"[{kind}] {k[:160]} {t / calls:.4f} ms x{c / calls:g}"
                      for k, t, c, kind in prof))
    src64 = src.long()  # widened before timing
    w = torch.from_numpy(spmv_breakdown.inputs(graph.n_nodes, graph.n_edges)["w"]).to("cuda")
    print(f"w[src] with the int32 index: {time_ms(lambda: w[src]):.4f} ms; with an int64 "
          f"index: {time_ms(lambda: w[src64]):.4f} ms")

    no_degrade("6")

    # 8. batch TF-IDF at config 2's size, then the PageRank loaders' native
    # layer against their numpy paths
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.io import graph as tg
    from page_rank_and_tfidf_using_apache_spark_tpu_torch.utils import native

    t0 = time.perf_counter()
    tfidf_phase(torch.device("cuda"), reset_counts, counts)
    check_graph_loaders(tg, native, graph)
    print(f"phase 8 (tfidf, loaders): {time.perf_counter() - t0:.1f} s")
    no_degrade("8")

    # 9. streaming TF-IDF: the chunk step against the CPU, the config-2 and
    # config-5 stand-ins against batch, the pinned copies, kill and resume
    card_label = f"{smi['device']}, {smi['power_limit']}"
    t0 = time.perf_counter()
    stream = streaming_phase(torch.device("cuda"), reset_counts, counts, card_label)
    print(f"phase 9 (streaming): {time.perf_counter() - t0:.1f} s")
    no_degrade("9")

    # 10. the servable index through the CLI
    t0 = time.perf_counter()
    index_phase(torch.device("cuda"), stream["docs"], stream["knobs"], stream["chunk_docs"],
                card_label)
    print(f"phase 10 (index): {time.perf_counter() - t0:.1f} s")
    no_degrade("10")

    # 11. serving: the scorers, the server, the CLI, the segments
    t0 = time.perf_counter()
    launches["serving"], qps = serving_phase(torch.device("cuda"), reset_counts, counts,
                                             card_label, stream["docs"], stream["wiki"])
    print(f"phase 11 (serving): {time.perf_counter() - t0:.1f} s")
    no_degrade("11")

    # 12. PageRank checkpoints and resume, PPR, HITS, components, cli.workloads
    t0 = time.perf_counter()
    workload_launches = workloads_phase(graph, reset_counts, counts, card_label)
    print(f"phase 12 (workloads): {time.perf_counter() - t0:.1f} s")
    no_degrade("12")

    # 13. chaos on the card: faults at the guarded sites, the guard's cost
    t0 = time.perf_counter()
    workload_launches["chaos"] = chaos_phase(graph, stream, loop_ms, qps, reset_counts, counts,
                                             card_label)
    print(f"phase 13 (chaos): {time.perf_counter() - t0:.1f} s")
    no_degrade("13")
    print(f"degraded events after phases 1-13: {degraded.n}")

    # 14. a lost device hands the run to the CPU
    t0 = time.perf_counter()
    workload_launches["degrade"] = degrade_phase(graph, stream, reset_counts, counts,
                                                 card_label)
    print(f"phase 14 (degrade): {time.perf_counter() - t0:.1f} s")
    obs.bus().detach(degraded)

    # 15. tuned profiles: the tuner's plan, the kernels over the knob domain,
    # two sweeps, the CLI's ladder, defaults against the committed profile
    t0 = time.perf_counter()
    workload_launches["tuned"] = tuned_phase(graph, stream["docs"], ranks_by_impl["hybrid"], smi,
                                             reset_counts, counts, card_label)
    print(f"phase 15 (tuned profiles): {time.perf_counter() - t0:.1f} s")

    # 16. the mesh of slots: the collectives, every PageRank strategy, the
    # shrink, sharded TF-IDF, the sharded workloads, --mesh
    t0 = time.perf_counter()
    workload_launches.update(sharded_phase(graph, stream, reset_counts, counts, card_label))
    print(f"phase 16 (mesh of {SHARD_SLOTS} slots on one card): {time.perf_counter() - t0:.1f} s")

    # 17. the fleet: replica processes on the card behind the router, the
    # respawn rung, drain by handoff, the floor, the peer cache, both soaks
    t0 = time.perf_counter()
    workload_launches["fleet"] = fleet_phase(stream["wiki"], reset_counts, counts, card_label)
    print(f"phase 17 (fleet): {time.perf_counter() - t0:.1f} s")

    # 18. the port's static analysis over the shipped tree, the
    # wire-protocol harness at a replica on the card, and the main-path
    # entries' traces held to one real step each
    t0 = time.perf_counter()
    workload_launches["analysis"] = analysis_phase(graph, reset_counts, counts, card_label)
    print(f"phase 18 (analysis): {time.perf_counter() - t0:.1f} s")

    # 19. the port's CI and chaos gates: the chaos scenarios on cuda:0 (a
    # mesh of the card's slots, replicas on the card) and the device smokes
    t0 = time.perf_counter()
    workload_launches["ci"] = ci_phase(reset_counts, counts, card_label)
    print(f"phase 19 (ci): {time.perf_counter() - t0:.1f} s")

    # 20. the reference's last drivers: the dry run with the owned-scale
    # sweep to 10x web-Google, the 1M-document rehearsal, the examples
    t0 = time.perf_counter()
    workload_launches["drivers"] = drivers_phase(reset_counts, counts, card_label,
                                                 sweep_graphs)
    print(f"phase 20 (drivers): {time.perf_counter() - t0:.1f} s")

    # 7. the kernels line, then the result line; launches are those of the
    # kernel's own path: cumsum's from the hybrid run (its tail's prefix
    # sum), segment's from the segment run
    meta = {
        "spmv": ("page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/spmv.cu",
                 "page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py:144",
                 launches["pallas"]["spmv"]),
        "cumsum": ("page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/cumsum.cu",
                   "page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py:78",
                   launches["hybrid"]["cumsum"]),
        "rowsum": ("page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/rowsum.cu",
                   "page_rank_and_tfidf_using_apache_spark_tpu/ops/pallas_kernels.py:118",
                   launches["hybrid"]["rowsum"]),
        "gather": ("page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/gather.cu",
                   "tools/gather_micro.py:77", launches["probes"]["gather"]),
        "segment": ("page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/segment.cu",
                    "page_rank_and_tfidf_using_apache_spark_tpu/ops/pagerank.py:378",
                    launches["segment"]["segment"]),
    }
    # the put's kernels replace host builders, not a TPU kernel: the JAX
    # package's put (dst, inv_out_strength) and the port's plan builders
    put_cu = "page_rank_and_tfidf_using_apache_spark_tpu_torch/csrc/put.cu"
    put_meta = {
        "spmv_rows": "page_rank_and_tfidf_using_apache_spark_tpu_torch/ops/pallas_kernels.py:158",
        "expand_dst": "page_rank_and_tfidf_using_apache_spark_tpu/ops/pagerank.py:281",
        "segment_coords":
            "page_rank_and_tfidf_using_apache_spark_tpu_torch/ops/segment_kernels.py:87",
        "node_vectors": "page_rank_and_tfidf_using_apache_spark_tpu/ops/pagerank.py:278",
    }
    # workload_launches: each kernel's launches in phase 12's counted runs
    # (12a's resumed runs, 12b's API runs, 12c's first runs), phase 13's
    # (13a's and 13b's faulted runs, 13c's resumed run), phase 14's (the
    # card's launches before each loss, and 14b's), phase 15b's (one run
    # of each layout and dtype), phase 16's (16b's float32 runs, 16c's
    # shrinking runs, 16e's runs, 16g's processes' runs), phase 17's (17f,
    # 17g), phase 18's (18b's harness, 18c's one real step an entry),
    # phase 19's (19a's scenarios, 19b's smokes) and phase 20's (20a's dry
    # run and sweep), by workload
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": n, **main_rows[name],
         "workload_launches": {w: c.get(name, 0) for w, c in workload_launches.items()}}
        for name, (src, replaces, n) in meta.items()
    ] + [
        {"name": name, "route": "cuda", "source": put_cu, "replaces": replaces,
         "launches": launches["segment"][name], **main_rows[name], "workload_launches": None}
        for name, replaces in put_meta.items()
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ALONE = {"--cards": cards_main, "--fleet": fleet_main, "--analysis": analysis_main,
             "--ci": ci_main, "--drivers": drivers_main}
    if len(sys.argv) == 2 and sys.argv[1] in ALONE:
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
            sys.exit(2)
        sys.exit(ALONE[sys.argv[1]]())
    sys.exit(main())
