#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``fairify_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

1. Environment and build: the card's name and power limit, the TF32-off
   numeric policy, and the nvcc build of every kernel in
   ``fairify_tpu_torch/csrc`` (build seconds, ptxas register/spill report).
1b. The lattice kernels vs plain versions, on the AC-S1 twin's stage-0
   leftovers of stress-AC and relaxed-AC partitions 0-1,024: K9a
   (lattice_scan) and K9b (lattice_signs) timed on the first full
   2^18-point chunk of stress-AC's largest E0-eligible leftover (V = 2)
   and on its tail chunk, K9c (lattice_scan_ra) on relaxed-AC's (V = 5,
   eps = 5, one aligned chunk); then, per preset, the first two chunks of
   every small leftover that card = CPU skips, the chunk that holds each
   card = CPU SAT witness, the first chunk with a
   sparse (2-512) and with a dense (> 512) margin count, and the crossing
   twin's chunk: the twin's E0 leftovers hold no certain flip (their SAT
   points sit inside the round-off bound, settled by the host ladder; on
   stress-AC the bound of the stretched inputs exceeds what the protected
   attribute moves the logit), so the same net with its protected columns'
   first-layer weights scaled up and its output bias moved to a level
   that a pair of certain logits straddles supplies one on a small
   leftover's first chunk (on relaxed-AC a core point whose partner lies
   in the ±eps window only; K9c again with its global-scratch dilation,
   the path of RA tiles past shared memory, forced).  On every chunk: (a) no
   opposite certain signs, (b) every kernel logit within its bound of a
   float64 forward, (c) a certain-vs-0 difference only at the bound's
   edge and on at most 0.1% of the points, (d) first flip, margin count,
   the ordered margin indices and the sign columns equal to the plain
   reductions of K9b's signs, and with nothing excused to the plain
   version's; (e) on the margin and flip chunks, copies with one certain
   sign flipped, one margin index dropped, two swapped or the flip lost
   fail.  The run fails unless a flip, a sparse and a dense margin were
   checked.  On each preset's timed chunk a cuBLAS fp32 chain (three addmm
   a layer: h W, |h| |W|, e |W|; TF32 off and asserted) is timed beside the
   kernels as the library yardstick of rows 22-24, and on the crossing
   twin's chunk the signs kernel under three forced geometries (points a
   warp tile, warps a block) must give K9b's signs, f and e and the scan's
   outputs bit for bit.  The overflow path: a net with a zero last layer
   (f = 0, every point a margin point; narrow, since each point then takes
   the exact rational forward) on a box of a few thousand points runs K9b and
   decides unsat on the card and the CPU.  Card = CPU: decide_box_exhaustive
   on the 8 (stress-AC) and 4 (relaxed-AC) smallest-lattice E0-eligible
   leftovers that the card decides within 2 s (a smaller box over the cap is one whose margin
   cells the host resolves exactly, the same work on both paths; its
   chunks are checked above) and on the crossing twin's box (sat through
   its first flip), the CPU plain path in a worker process beside the
   rest of phase 1b, phases 2-2c and 4, verdicts and witnesses equal.
2. Stage-0 kernels vs plain versions: KA (sim_and_bounds), KB
   (stage0_certify; on the AC segment also its default launch bit for bit
   under three forced geometries), KC (attack_flips; on the GC grid, the AC
   segment and the AC chunk its default launch bit for bit under the four
   KC_FORCES geometries, timed two ways beside its forward's cuBLAS chain,
   ``kc_library``) and KD (parity) at
   the shapes the
   main path gives them — the GC grid (201 partitions, GC-1 twin 20-50-1)
   and one segment of the AC grid (16,000 partitions, AC-S1 widths
   13-128-64-32-16-8-1, seeded weights), and one relaxed-AC segment (ε = 5
   on age, 5 race assignments) for the relaxed-attribute terms.  KA and KD
   timed two ways (the wrapper, and its C entry point alone,
   ``time_split``) beside their library chains timed the same two ways
   (events around the calls, and CUDA-graph replays: ``graph_ms``) and the
   draw's floor from its SASS (``[draw SASS]``: a probe kernel's
   instructions counted with ``cuobjdump``); on the GC grid and the
   AC segment's first 512 partitions, at sim_size 1,000 and 37, KA, row 3
   (KA's simulation half) and KD bit-equal (``torch.equal``) under four
   forced geometries of both regimes (one block a partition at 16- and
   32-row tiles, blocks of 5 tiles that span two partitions, one tile a
   block), row 3 equal to KA's cand and pos ("[geometry ...]").
   Refinement kernels vs plain versions: K5 (pgd_attack) on one 2,048-box
   launch of real AC-S1 stage-0 leftovers (96 restarts, 60 steps, and
   again 0, 1 and 4 steps; at the heuristic retry's shape, 32 single-box
   launches (B = 1) judged together as 3,072 trajectories, the median
   launch timed; at one trajectory a warp tile and one warp a block
   against its largest tile, bit-equal) and K6 (bab_segment) on one
   8-round segment of a 512-slot queue of them, with alpha_iters 0 and 8;
   both again on GC boxes and on relaxed-AC leftovers; K12's row
   generator (sim_rows, from (seed, index), keys derived in the kernel) on
   one partition's samples, timed through the wrapper and by its C entry
   point alone, and bit-equal on the first partition, the whole domain
   (its widest spans) and a box with a span-1 dimension (the draw KA, row
   3 and KD share), at a seed past 2**32 from an index past 65,535 and
   under key words with a nonzero high word; K12's key kernel (grid_keys)
   bit-equal to the torch threefry on the card at a segment's keys, and
   ``parity_resim``'s per-call split on 64 AC-S1 leftovers ("[parity_resim
   split]": launch, sync, forwards; the parent path's eager key and box
   copies beside them).  K5's trajectories
   may end elsewhere only where the plain path met a threshold, and at
   most 0.1% of them may;
   K6's segment must equal the plain version's in every queue buffer,
   latch and counter, and at the AC shape (α 0 and 8) its own default
   launch's bit for bit under three forced geometries (warps a block, one
   block an SM); sim_rows must be bit-equal.  Copies of the
   kernels' outputs with one point, latch, counter or slot shifted by one
   must fail these checks.  A toy world through decide_many agrees with
   the brute-force oracle.
   Phase-S/L/P kernels vs plain versions (2c) on 512 real AC-S1 stage-0
   leftovers' sign boxes: K8a (sign_bound) at alpha_iters 8 and 0 on the
   root pattern and on branches of depth 1-8 that one plain
   ``uniform_sign_bab`` frontier over those roots bounded (64 nodes a
   root, so every run bounds the same branches) — its final α/β must
   equal the plain version's on every box not excused (a box is excused
   only where a gradient on the plain path has another sign in f32 than
   in f64, and at most 1% may be), and there the bounds and scores agree to
   tolerance, ``feasible`` and ``resolved`` are equal and the bounds
   contain the f64 bounds of the same relaxations up to that tolerance
   (a failing check writes its boxes under chiprun_out/chip_smoke/); on the
   AC-S1 frontier branches at α 8 and 0 its default launch bit for bit
   under three forced geometries (warps a block); K8b
   (inter_bounds) at B = 512, over 1 and 17 live rows of a 512-row pad
   (past them equal to the full launch bit for bit) and at one root's
   2V = 4 role boxes, each bit-equal under four forced geometries (warps,
   boxes a block) and timed two ways (the wrapper, and its C entry point
   alone, 300 launches back to back); the
   role logits at Phase S's shape (row 21; row 17's wrapper on the same
   rows bit-equal to it, both beside the library forward).  The same on
   relaxed-AC (ε = 5) boxes.
   Copies of the outputs with one resolved sign flipped, one lower bound
   raised past its f64 bound, one K8b bound or one logit moved must fail.
3. End to end, stage 0 only: ``verify_model`` on the GC-1 twin with the
   GC preset; requires sat=2 unsat=199 unknown=0, every ledger row
   CRC-valid, every SAT witness exact, KA–KD launched.
4. bench.py's BaB ladder world on the card: verdicts equal to the port's
   plain run on the CPU (and with max_nodes=1, through the heuristic
   retry), in the slice-2, the slice-3 and the default configuration.
5. Real size: ``verify_model`` over the whole AC grid (16,000 AC-S1
   partitions, two mega-segments) in the slice-2 configuration under a
   30 s hard budget; ``verify_model`` on AC-S1 partitions 0-2,048 through
   stage 0, PGD, the device BaB and the heuristic retry in the slice-2
   configuration (Phases S, L, P, E0/E off) and in the slice-3
   configuration (``EngineConfig(lattice_exhaustive=False)``: Phases S, L
   and P on), 45 s hard each — each under a fixed node and time budget,
   with every kernel of the path launched, every partition ledgered,
   every SAT replayed exactly and every unknown ledgered with the
   engine's reason (phase 6 likewise).  K6's launches in both tails are
   split by (α, live slot-rounds: the segment's nodes sum, up to the next
   power of two); each bucket is timed on its first launch's inputs, the
   slice-2 tail's most frequent one also against the plain version.
   Both tails' ``parity_resim`` calls are clocked ("[parity_resim, ...]"),
   one K12 launch each.

6. This slice's main path: ``verify_model`` on the AC-S1 twin over
   stress-AC and relaxed-AC partitions 0-1,024 in the JAX engine's default
   configuration (``EngineConfig(max_nodes=1000)``: Phases E0 and E on),
   0.1 s soft per leftover, 75 s hard: K9a launched on stress-AC, K9c on
   relaxed-AC, Phase E0 deciding partitions on both; counts,
   decided_fraction, decisions by engine phase, engine phase seconds,
   unknown reasons and launches per kernel printed.  Phase 4 also runs the
   ladder world in the default configuration, card = CPU.

7. Stacked families, the chunk loop and the host-frontier BaB.  (a) A
   family of four AC-S1 twins (seeds 0-3; seed 0 is phases 5 and 6's net)
   through ``stage0_families`` on the whole 16,000-partition AC grid: one
   KB + one KC launch per segment over chunks x models x rows; each
   model's verdicts, witnesses and histograms equal its solo stage 0; per
   segment the family KB/KC outputs equal each model's solo launch bit for
   bit (fold = wraparound sum of the solo folds), and on the first segment
   their plain versions within the tolerances of phase 2 (KC also bit-equal
   under KC_FORCES, timed two ways beside its library chain); CUDA-event times
   per family segment beside the sum of the four solo launches, with the
   bound; on one 2,048-row chunk (row 7) the family KB/KC times beside
   the solo sum, and a wide family of 11 AC-S1 twins bit-equal per model
   to the solo launches at α = 0 and 8, KB's shared memory per block
   (``engine.kb_geometry``) printed.  (b) The zoo's CP and DF groups as 11 seeded twins each
   (6-32-32-1, 30-16-16-16-1) on their own presets: the family chunk loop
   (``mega_chunks=0``) and ``verify_model(stage0=...)`` per model, whose
   ledger, CSV and funnel equal the model's solo ``verify_model``.  (c) The
   chunk loop: GC-1 at ``mega_chunks=0`` equal to the mega path (ledger,
   CSV, funnel); the AC grid's prune, stage 0 and parity in 8 launches
   each against the mega path's 2 (masks, bounds, parity, verdicts,
   witnesses, histograms equal); KA, KB, KC and KD on one 2,048-row chunk
   against their plain versions, and KA, row 3 and KD over 1 and 17 live
   rows of it equal to the full launch ("[live rows ...]"); the chunk
   loops' KA and KD launches by (kind, rows, live rows): GC-1's one
   201-row chunk, the AC grid's last chunk over its 1,664 live rows of
   2,048, timed beside a launch over all 2,048 ("[sim launches by shape,
   chunk loops]").  (d) The host frontier: the ladder world
   at ``device_bab=False``, card = CPU = the device BaB's verdicts; KB at
   α = 8 and 0 with the branching score, and KC, on 512 AC-S1 stage-0
   leftovers (the frontier batch F = 512, 16 candidates) against their
   plain versions: margins and scores within tolerance, and every box's
   first three split dims (``score·width``, stable) equal except at a
   near-tie within the score tolerance, on at most 1% of the boxes; KB's
   default launch there bit for bit under three forced geometries; KC's
   under KC_FORCES; KB and KC over 1 and 17 live boxes of the 512 equal to
   the full launch's rows and their fill ("[live rows ...]"), KC timed two
   ways beside its library chain.  (e)
   End to end, after the CPU worker: the family's stage-0 results of AC
   partitions 0-4,096 through ``verify_model(stage0=...)`` per model in the
   default configuration, 8 s hard: the stage-0-decided rows equal each
   model's solo stage 0; the rest are deadline-bound and reported.

8. The IBP path (``use_crown=False``: K10's rows 13 and 17, ``role_bounds``
   and ``attack_logits``, and their family forms, rows 8 and 9) and the
   exact-certify pass.  The phase fails first unless the native exact core
   is loaded.  Kernel checks: row 13 in IBP and CROWN mode and
   row 17 on one 2,048-row AC chunk (2,048 x V role boxes per role, 128
   candidates) and at the host frontier's shape (512 AC-S1 stage-0
   leftovers, 16 candidates) against their plain versions — bounds to
   TOL_REL of their interval magnitude and within a quarter of the
   widening slack, containing, on 256 role boxes
   per role, their float64 interval bounds (IBP) or sampled float64 logits
   (CROWN); logits to TOL_REL of their rounding scale; a copy with one
   bound moved past its float64 bound, with every bound moved inward by
   one slack (the output widening removed), or with one logit moved, must
   fail; row 13 also over 17 and 1 live boxes of the F = 512 pad (past
   them equal to the full launch), in IBP mode bit-equal to its
   plain-order reference (``ibp_ordered``: the kernel's fmaf order, exact
   on the card), in both modes bit-equal under three forced geometries,
   timed two ways (the wrapper and its C entry point alone) and, in IBP
   mode, beside the library chain (``library_interval``: the centre-radius
   image in cuBLAS fp32); the
   library forward (a cuBLAS fp32 chain) timed beside row 17; row 17's
   logits at its smallest rows per block (4-row warp tiles, one warp a
   block) and its largest bit-equal.  (8c) The
   family of four AC-S1 twins through ``stage0_families`` on the whole AC
   grid (8 chunks, one launch of each row per chunk), each model equal to
   its solo stage 0; on one chunk the family rows 8 and 9 bit-equal per
   model to the solo rows 13 and 17, row 8 bit-equal under three forced
   geometries and timed beside its library chain.  (8d) The ladder world on the IBP
   path (the host frontier's non-fused branch), card = CPU.  End to end,
   after the CPU worker: (8a) the GC-1 twin on the GC preset with only
   ``use_crown`` changed (exact-certify on): sat=2 unsat=199 unknown=0,
   ledger and CSV equal to the CPU's, ``sv_time_s`` printed; then the
   preset on the CROWN path with exact-certify on; (8b) the whole AC grid
   on the IBP path in phase 5's configuration (30 s hard); (8e) the
   exact-certify pass over the whole AC grid through the native exact
   core: ``sv_time_s``, and 48 partitions' masks
   equal to the port's Fraction pass on the CPU (a flipped mask fails).

9. The mesh path (``parallel.mesh``: rows 14 and 6, KB launched as the
   certificate alone), harsh pruning (row 3, KA's simulation half) and the
   standalone α-CROWN bounds (K7, ``role_bounds.cu``), after the CPU
   worker.  (9a) The GC-1 twin over a 1 x 1 mesh (``make_mesh``): sat=2
   unsat=199 unknown=0, verdicts equal to mesh=None's, ledger and CSV
   equal to the port's one-shard CPU mesh run, row 14 and row 17 once per
   chunk, KB and KC never; decided partitions/s of both runs.  (9b) The
   same over ``submesh([cuda:0] * 3)`` (ragged shard padding): rows equal
   9a's.  (9c) The AC-S1 twin, AC partitions 0-2,048: stage 0 over a 1 x 1
   mesh bit-equal to the fused mesh=None stage 0; then verify_model both
   ways in the slice-3 configuration, 10 s hard, decided fractions
   printed.  (9d) Row 14 on one 2,048-row AC chunk at α = 0 and on the
   host frontier's F = 512 leftovers at α = 8 against its plain version
   (phase 7's KB rule); row 6 (M = 4) on the chunk bit-equal per model to
   four solo launches, its plain version timed beside; K8a and K8b over a
   3-shard submesh bit-equal to the unsharded launches.  (9e) The ladder
   world over 3 shards in the slice-3 configuration and on the IBP path,
   card = CPU; the four AC-S1 twins through ``stage0_families`` and
   ``uniform_sign_bab`` over 3 shards equal to mesh=None's.  (9f) ``harsh_prune_grid`` over the whole AC grid:
   one row-3 launch, candidates equal to KA's full launch bit for bit, and
   row 3 against its plain version by phase 2's KA rule, timed two ways
   (``time_split``) beside the library chain over all 16,000 partitions'
   samples (both ways) and the draw's floor.  (9g)
   ``alpha_crown_output_bounds`` (K7, iters 8) on 512 AC-S1 leftovers:
   within the widening slack of its plain version (at most 1% of boxes
   excused), containing float64 sampled logits, no looser than plain
   CROWN, timed two ways (``time_split``); the same boxes under the three
   K7_FORCES geometries bit-equal to the default launch, the C entry point
   refusing a wrong shared-memory size and a block of no boxes,
   ``widen=False`` against its plain version, boxes with leading axes
   bit-equal to the flat launch; and K7 at B = 1, 17 and 2,048 held and
   timed the same way.
10. The trained nets (``fairify_tpu_torch/models/scaled/*.npz``, loaded
   with numpy only: AC-S1, AC-S2, BM-S1, BM-S2).  (10a) Trained AC-S1's
   stage 0 (prune, certificate + attack, parity) over AC partitions
   0-256 on the card, which the CPU worker repeats: rows (id, verdict,
   witness) equal; partitions whose dead masks or parity differ counted.
   (10b) After phase 6, trained AC-S1 in phase 6's configuration
   (``EngineConfig(max_nodes=1000)``, 0.1 s soft, 75 s hard) on its
   stress-AC cell (partitions 0-1,024) and on stress-AC partitions
   1,024-4,096 (with the cell, the prefix the JAX package's
   stress-AC-scaled AC-S1 row attempted): counts, decided fraction,
   first-pass decisions by engine phase,
   and (``LatticeTally``, from outside the package) how Phase E0's and
   E's roots end — a certain flip, a margin cell, unsat, an evidence
   mismatch (the masked-net quirk on the heuristic retry's masked nets) or
   the deadline — and how often ``_EvidenceMismatch`` was raised.  (10c)
   After 9g, K7 on trained AC-S1's stage-0 leftovers by 9g's rule.  (10d)
   Row 17 of each trained net on 4,096 seeded domain points per role
   against the float64 forward.
11. The runtime contracts (the launch pipeline on CUDA events, the
   supervisor and fault injection, the obs layer, the sampled recheck).
   (11a) Pipeline depths 1, 2 and 4: GC-1 end to end on the chunk loop
   (``grid_chunk=26``: 8 chunks) and on the mega path (2 segments of 4
   chunks) — ledger rows, CSVs (less time columns), funnels, histograms
   and launch counts equal at every depth and between the paths — and the
   AC grid's stage 0 and parity passes through one pipeline, 8 chunks
   and 2 segments — verdicts, witnesses, parity and histograms equal —
   with ``launches_in_flight`` max and mean and the stage-0 and parity
   seconds at each depth ("[pipeline depth ...]").  (11b) One submit of
   each pipelined path (prune block, mega segment, fused chunk, IBP
   chunk, 3-shard mesh chunk, family segment, parity block, PGD chunk,
   device-BaB segment) and its fetch's start under
   ``torch.cuda.set_sync_debug_mode("error")``: no implicit sync
   ("[sync check]").  (11c) GC-1 under ``launch.decode:transient:1``
   (absorbed: one retry, rows equal the fault-free run's; a re-dispatched
   segment payload bit-equal to the first), ``launch.submit:fatal:1``,
   ``launch.decode:corrupt:1`` (caught by the fold or the canary) and
   ``ledger.append:corrupt:1`` (caught by the CRC on reload), each
   followed by a resume that must give the fault-free rows ("[faults
   ...]").  (11d) GC-1 with ``trace_out``, ``heartbeat_s`` and
   ``profile_dir``: the event log loads and holds every phase span and
   the verdict events; the ``torch.profiler`` trace holds KA under
   ``stage0_prune``, KB and KC under ``stage0_decide`` and KD under
   ``stage0_parity`` ("[trace and profiler]").  (11e) GC-1 at
   ``integrity_recheck=1.0``: every chunk rechecked, no violation, and the
   exact oracle confirms each chunk's first certified partition or leaves
   it inconclusive, never refutes it ("[sampled recheck]").
12. The SMT tier and ``run_sweep``.  (12a) SMT_SPAWNS fresh SMT workers
   spawned one after another from this process (CUDA live), their seconds
   to hello; tests/test_torch_bab.py's world (20-4-1, seed 3; the GC-1
   twin's stage 0 and BaB leave the tier no root) on the GC preset with
   its domain shrunk to 8-16-pair boxes, ``EngineConfig(max_nodes=1,
   attack_samples=4)`` with Phases S, L, P, E0/E off, ``smt_retry_timeouts_s
   =(10.0,)``, a pool of 2 workers capped at 2,048 MB (a worker that
   touched CUDA would die under it) shared by a blocking run at
   ``integrity_recheck=1.0`` and an ``smt_defer`` run (its first dispatch
   hung: at least one root deferred): at least
   SMT_MIN_QUERIES queries; verdict map, ledger rows, CSV rows and
   ``smt_reason`` fields equal the CPU worker's; every SMT UNSAT rechecked
   and confirmed by ``decide_pair_box_exact``; no live worker maps
   ``libcuda`` or ``libtorch``; the drain converges to the blocking map;
   ``smt.worker.crash``, ``.hang`` and ``.memout`` (``transient:1``) each
   retried exactly as on the CPU; and a world whose stage 0, PGD, BaB and
   retry are stubbed to decide nothing, through a brute-backend pool whose
   pair cap concedes its 16-pair boxes: card = CPU, its SMT SAT witnesses
   replayed.  Where z3 is installed (the ``auto`` backend is then z3), the
   in-process ``decide_box_smt`` gives the pool's verdicts, and the SAT
   world through a z3 pool decides every root, its witnesses replaying.
   (12b) ``run_sweep`` over a model root of the GC-1 twin and a second
   20-50-1 twin (``.npz``; stacked as a family: KB and KC as rows 5 and 7)
   and a synthetic ``german.data`` of 1,000 rows, ``partition_metrics`` on:
   reports, ledgers, CSVs and metrics CSVs (to 1e-6) equal the CPU
   worker's; two host slices' ledgers make the whole run; ``retry_unknown``
   leaves one row per partition; ``n_shards`` raises naming item 7.  The
   CPU side of both runs in the CPU worker.
13. The experiment path and its training kernels (rows 25-28,
   ``csrc/train_step.cu``).  The real Adult file is not in the repository:
   30,000 training and 5,000 test rows are drawn from the AC preset's adult
   domain, labelled by trained AC-S1 with 10% of the labels flipped, from a
   seed (``synthetic_adult``).  (13c) ``run_experiment`` on trained AC-S1,
   ``repair_mode="both"``, over the AC preset capped at max_partitions=512
   (288 partitions) with the slice-2 tail, node cap 200, under a 300 s hard
   budget; its card side runs right after 10a, every count zeroed before
   it, and writes the repaired weights for the CPU worker, which runs the
   same experiment (without the re-verification) and then re-verifies and
   audits the card's weights (``experiment.audit``): the first sweep's
   counts, ledger and CSV rows, pairs and localization equal; the repaired
   weights and the repair histories within tolerance, ``floor_ok``,
   ``group_ok`` and ``selected`` equal; on the card's weights
   ``fairer_verdicts``, ``routing``, ``metrics`` and ``causal_rates``
   equal.  (13b) ``train_mlp`` from ``init_mlp`` at AC-S1's widths, 3
   epochs at B = 128 (702 launches of row 25): epoch losses within
   tolerance of the CPU worker's, test predictions equal on >= 99.5%.
   (13a) rows 25 (B = 128), 26 (B = 32 and the ragged last batch, masked
   by 13c's localized neurons), 27 (B = 64 on 13c's pairs) and 28 (all of
   them): one step from one state within tolerance of the plain version,
   100 steps' losses, two launches bit-equal, every masked entry
   bit-unchanged, mutants rejected; each timed beside its bound, its plain
   version, and the library step (autograd + ``Adam(fused=True)``, a CUDA
   graph).
14. The synthetic-data path and the synthesizer's kernels (rows 29-30,
   ``csrc/synth_step.cu``).  (14b) ``fairify_tpu_torch.scripts.
   synthetic_models`` at the JAX script's defaults (SYN_ARGS: copula, ar
   and bootstrap, 2,000 rows, 200 AR epochs, 20-50-1 nets, 30 epochs) on
   a synthetic German file (``write_german``); its card side runs right
   after 13c's, every count zeroed before it (800 launches of row 29, one
   of row 30), and writes the AR fit's inputs and outputs, the draw and
   the nets' files for a worker of its own (``--synth-cpu``), which runs
   the same fit (initial weights bit-equal; its first SYN_TIGHT_EPOCHS
   epochs within phase 13's tolerance, every epoch's loss within
   SYN_HIST_REL), the plain draw from the card's fitted weights (rows
   equal but at near ties, at most SYN_TIE_CAP of them) and
   ``verify_model`` of each net the card wrote (counts, ledger and CSV
   rows, accuracy equal).  (14a) row 29 at the fit's shape (B = 256 and
   the ragged last batch) and row 30 at n = 2,000 on the card's fitted
   weights: one step within tolerance, 100 steps' losses, bit-equal
   twice, padded-class entries bit-unchanged, the draw under the
   near-tie rule, one column's uniforms bit-equal to ``prng.uniform``,
   mutants (a moved θ entry, a moved padded entry, a shifted key, a
   shifted logit) rejected; each timed beside its bound, its plain
   version and its library yardstick.

Phase 4 runs before phase 3, and the run waits for the CPU worker's card
= CPU results before phase 3, so the timed end-to-end phases 3, 5, 6, 7e,
8a, 8b, 8e, 9, 10b, 10c and 11 run beside only its phase-12 and phase-13
CPU sides, on two threads, which phases 12 and 13 wait for (10a's and
13c's card sides, 7a-7d and phase 8's kernel checks, 8c and 8d run beside
the whole worker).

Every ``run_sweep``/``counted`` window splits K8a's launches by (α, live
rows up to the next power of two), KB's (rows 4-7, 14, 15) by (α, boxes,
models), K8b's by (engine phase L or P, live rows) and row 13's (and 8's)
by (mode, role boxes, live boxes, models), and KA's, row 3's and KD's by
(kind, rows, live rows), and fails unless the split adds up to the
counters; after phase 9 every bucket is timed on its first
launch's inputs and each window's launches x (time - bound) printed
("[K8a by shape, ...]", "[KB by shape, ...]", "[K8b by shape, ...]",
"[row 13 by shape, ...]"), and K8a's launch over the live rows of the
slice-3 tail's most frequent bucket must equal the full launch bit for
bit.  KA's and KD's checks time a cuBLAS forward of the same samples
beside them (``library_sim_forward``).

The next-to-last lines are the kernel table as one JSON object (K5's
launches in the slice-3 AC-S1 tail split by B, K6's in both tails by (α,
live slot-rounds), K8a's, KB's, K8b's and row 13's in every window by
shape, row 17's on the IBP AC grid by row count) and the
``nvidia-smi`` name/power line; the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

REPLACES = {
    "sim_and_bounds": "fairify_tpu/verify/pruning.py:76",
    "stage0_certify": "fairify_tpu/verify/sweep.py:812",
    "attack_flips": "fairify_tpu/verify/sweep.py:812",
    "parity": "fairify_tpu/verify/sweep.py:1403",
    "pgd_attack": "fairify_tpu/verify/engine.py:668",
    "bab_segment": "fairify_tpu/verify/engine.py:593",
    "sim_rows": "fairify_tpu/verify/sweep.py:1420",
    "grid_keys": "fairify_tpu/utils/prng.py:19",
    "sign_bound": "fairify_tpu/verify/engine.py:957",
    "inter_bounds": "fairify_tpu/verify/engine.py:963",
    "role_logits": "fairify_tpu/verify/engine.py:1035",
    "lattice_scan": "fairify_tpu/ops/lattice.py:195",
    "lattice_signs": "fairify_tpu/ops/lattice.py:238",
    "lattice_scan_ra": "fairify_tpu/ops/lattice.py:246",
    "role_bounds": "fairify_tpu/verify/engine.py:51",
    "attack_logits": "fairify_tpu/verify/engine.py:615",
    "role_certify": "fairify_tpu/verify/engine.py:283",
    "sim_stats": "fairify_tpu/verify/pruning.py:107",
    "alpha_crown": "fairify_tpu/ops/crown.py:369",
    "train_step": "fairify_tpu/models/train.py:66",
    "fit_step": "fairify_tpu/analysis/repair.py:68",
    "pair_step": "fairify_tpu/analysis/repair.py:284",
    "pair_inconsistency": "fairify_tpu/analysis/repair.py:303",
    "synth_step": "fairify_tpu/models/synth.py:283",
    "synth_draw": "fairify_tpu/models/synth.py:315",
}
# The other TPU kernel sites each kernel replaces: the chunk loop's
# one-chunk forms (rows 1, 10, 15), the family kernels (rows 5, 7) and
# the host frontier's certificate + attack (row 15).
ALSO_REPLACES = {
    "sim_and_bounds": ["fairify_tpu/verify/pruning.py:58"],
    "stage0_certify": ["fairify_tpu/verify/sweep.py:857", "fairify_tpu/verify/sweep.py:1072",
                       "fairify_tpu/verify/engine.py:387"],
    "attack_flips": ["fairify_tpu/verify/sweep.py:857", "fairify_tpu/verify/sweep.py:1072",
                     "fairify_tpu/verify/engine.py:387"],
    "parity": ["fairify_tpu/verify/sweep.py:1374"],
    "role_bounds": ["fairify_tpu/verify/sweep.py:1090"],
    "attack_logits": ["fairify_tpu/verify/sweep.py:1099"],
    "role_certify": ["fairify_tpu/verify/sweep.py:1055"],
}
# Kernels of the slice-2 configuration's path (Phases S, L, P off).
SLICE2 = ("sim_and_bounds", "stage0_certify", "attack_flips", "parity", "pgd_attack",
          "bab_segment", "sim_rows", "grid_keys")
# The three lattice kernels share one source; the preset whose default run
# gives each its launch count, and the other one.
LATTICE_KERNELS = {"lattice_scan": "stress-AC", "lattice_signs": "stress-AC",
                   "lattice_scan_ra": "relaxed-AC"}
LATTICE_OTHER = {"lattice_scan": "relaxed-AC", "lattice_signs": "relaxed-AC",
                 "lattice_scan_ra": "stress-AC"}
# The role-logit forward (row 21) launches row 17's kernel with one model;
# rows 14 and 6 launch KB, row 3 KA's simulation half, K7 role_bounds.cu,
# the partition keys K12's key kernel.
KERNEL_SOURCE = dict({k: "lattice_scan" for k in LATTICE_KERNELS}, role_logits="attack_logits",
                     role_certify="stage0_certify", sim_stats="sim_and_bounds",
                     alpha_crown="role_bounds", grid_keys="sim_rows", fit_step="train_step",
                     pair_step="train_step", pair_inconsistency="train_step",
                     synth_draw="synth_step")
SOURCES = {k: f"fairify_tpu_torch/csrc/{KERNEL_SOURCE.get(k, k)}.cu" for k in REPLACES}
# Kernels every default-configuration run (phase 6) must launch, besides
# its preset's lattice scan: stage 0, the PGD, Phase S and the retry's rows.
DEFAULT_PATH = ("sim_and_bounds", "stage0_certify", "attack_flips", "parity", "pgd_attack",
                "sign_bound", "role_logits", "grid_keys")
DEFAULT_SOFT_S, DEFAULT_HARD_S = 0.1, 75.0
# Hard budget of the AC-S1 tail runs in the slice-2 and slice-3
# configurations (phase 5), short enough to leave room for phase 6.
TAIL_HARD_S = 45.0
# Phase 9's kernels: row 14 (and 6) of the mesh path, row 3 and K7 of their
# own entry points.
MESH_KERNELS = ("role_certify", "sim_stats", "alpha_crown")
# Rows 25-28, the experiment path's training kernels (phase 13).
TRAIN_KERNELS = ("train_step", "fit_step", "pair_step", "pair_inconsistency")
# Rows 29-30, the synthesizer's kernels (phase 14).
SYNTH_KERNELS = ("synth_step", "synth_draw")
# Kernels of the slice-3 configuration's path (lattice phases off; K10 is
# the IBP path's, phase 8; MESH_KERNELS phase 9's; TRAIN_KERNELS phase 13's;
# SYNTH_KERNELS phase 14's).
SLICE3_PATH = tuple(k for k in REPLACES if k not in LATTICE_KERNELS
                    and k not in ("role_bounds", "attack_logits") + MESH_KERNELS
                    + TRAIN_KERNELS + SYNTH_KERNELS)
AC_SIZES = (13, 128, 64, 32, 16, 8, 1)  # models_scaled/adult/AC-S1.h5 widths


T0 = time.perf_counter()


def clock(label: str) -> None:
    """Where the run's time goes: each phase's start, seconds into the run."""
    print(f"[clock] {label} at {time.perf_counter() - T0:.1f} s", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int):
    """(result, median ms) of ``fn()`` over ``reps`` CUDA-event-timed runs
    after one warm-up run."""
    import torch

    res = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return res, sorted(times)[len(times) // 2]


# Kernel vs plain version on the card: the two sum in different orders, so
# f32 values (bounds, margins, gaps, logits of O(1)) agree to
# TOL_REL * |v| + TOL_ABS; discrete outputs must be equal except where the
# value that decides them lies on a threshold within that tolerance.
TOL_REL, TOL_ABS = 1e-4, 1e-5
# Along a K5 trajectory (60 steps, each a forward and a backward pass) a
# sign is lost to the summation order only within a few tens of ulps of the
# sum's magnitude; the path checks use that band, not the value tolerance.
PATH_REL, PATH_ABS = 4e-6, 1e-7
# Of K5's trajectories at most this share may end at another point than the
# plain version's (each on a path that met a threshold): a wrong start,
# schedule, step or backward pass moves nearly all of them.
PGD_DIFF_SHARE = 1e-3


def tol_ratio(got, want, scale=None) -> float:
    """Largest |got - want| as a multiple of the tolerance
    TOL_REL * max(|want|, scale) + TOL_ABS (<= 1 passes)."""
    import torch

    if got.numel() == 0:
        return 0.0
    mag = want.abs() if scale is None else torch.maximum(want.abs(), scale)
    return float(((got - want).abs() / (TOL_REL * mag + TOL_ABS)).max())


def macs(sizes) -> int:
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def bound(flops: float, nbytes: float):
    t_ops, t_mem = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


# The draw's floor (common.cuh:draw_value, the draw KA, row 3, KD and K12
# share) comes from the instructions of one value, counted in the SASS of a
# probe built from the checkout's common.cuh: a kernel that draws one value
# a thread, less one that only reads the same parameters and stores.  Per
# SM and clock Hopper issues 128 thread-instructions and runs 64 integer
# and 16 conversion or special-function ones (the CUDA programming guide's
# throughput table, compute capability 9.0); 132 SMs at 1.98 GHz at most.
# The same probe counts one partition key (common.cuh:fold_in, K12's key
# kernel) against a base that stores its inputs.
DRAW_PROBE = r"""
#include "common.cuh"
extern "C" __global__ void draw_probe(SplitKey k, unsigned long long n, uint32_t minval,
                                      uint32_t span, uint32_t mult, float* out) {
  out[threadIdx.x] = draw_value(k, n + threadIdx.x, minval, span, mult);
}
extern "C" __global__ void draw_probe_base(SplitKey k, unsigned long long n, uint32_t minval,
                                           uint32_t span, uint32_t mult, float* out) {
  out[threadIdx.x] = (float)(int32_t)(minval + (uint32_t)(n + threadIdx.x) +
                                      (k.hi0 ^ k.hi1 ^ k.lo0 ^ k.lo1 ^ span ^ mult));
}
extern "C" __global__ void key_probe(uint32_t s0, uint32_t s1, uint32_t i0, long long* out) {
  uint32_t f0, f1;
  fold_in(s0, s1, i0 + threadIdx.x, f0, f1);
  out[2 * threadIdx.x] = (long long)f0;
  out[2 * threadIdx.x + 1] = (long long)f1;
}
extern "C" __global__ void key_probe_base(uint32_t s0, uint32_t s1, uint32_t i0,
                                          long long* out) {
  out[2 * threadIdx.x] = (long long)(s0 ^ (i0 + threadIdx.x));
  out[2 * threadIdx.x + 1] = (long long)s1;
}
"""
SASS_INT = {"IMAD", "IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL", "SHR",
            "ISETP", "IMNMX", "SEL", "LEA", "PRMT", "IABS", "POPC", "FLO", "BREV", "IMUL",
            "IMUL32I", "ISCADD", "IMAD32I", "VIADD", "VIMNMX"}
SASS_CVT = {"I2F", "F2I", "I2FP", "F2IP", "F2F", "I2I", "MUFU"}
SASS_SKIP = {"NOP", "EXIT", "BRA", "RET"}
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9
DRAW_SASS = None  # set by start_draw_probe / finish_draw_probe
KEY_SASS = None  # one partition key's, set by finish_draw_probe


def start_draw_probe():
    """Start building the draw probe (a cubin beside the kernels' libraries)
    and return ``(process, cubin path)``; None where nvcc is missing."""
    from fairify_tpu_torch.utils import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, "draw_probe.cu")
    with open(src, "w") as fp:
        fp.write(DRAW_PROBE)
    cubin = os.path.join(cuda_build.BUILD_DIR, "draw_probe.cubin")
    cmd = [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-cubin", "-I", cuda_build.CSRC, "-o", cubin, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), cubin


def sass_counts(text: str) -> dict:
    """Per function of ``cuobjdump -sass`` output, its instructions by
    class: ``int`` (integer arithmetic, logic, shifts, compares),
    ``cvt`` (conversions and special functions) and ``all`` (every vector
    instruction but NOP, EXIT and branches; uniform-datapath ones, U*,
    excluded)."""
    import re

    res, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = res.setdefault(m.group(1), dict(int=0, cvt=0, all=0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur is None or not m:
            continue
        op = m.group(1).split(".")[0]
        if op in SASS_SKIP or op.startswith("U"):
            continue
        cur["all"] += 1
        cur["int"] += op in SASS_INT
        cur["cvt"] += op in SASS_CVT
    return res


def finish_draw_probe(started) -> None:
    """Count draw_value's SASS instructions (the probe less its base) into
    DRAW_SASS, and print them; where the probe or cuobjdump fails, the
    floor stays unmeasured (a note, not a failure: it is a measurement)."""
    global DRAW_SASS, KEY_SASS
    from fairify_tpu_torch.utils import cuda_build

    proc, cubin = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        print(f"[draw SASS] not measured: the probe did not build:\n{log[-2000:]}", flush=True)
        return
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True, timeout=120)
    counts = sass_counts(out.stdout)
    if out.returncode != 0 or not {"draw_probe", "draw_probe_base"} <= set(counts):
        print(f"[draw SASS] not measured: cuobjdump returned {out.returncode} "
              f"({out.stderr.strip()[-500:]})", flush=True)
        return
    for probe in ("draw", "key"):
        if not {f"{probe}_probe", f"{probe}_probe_base"} <= set(counts):
            print(f"[draw SASS] {probe}: not measured (no such function in the cubin)",
                  flush=True)
            continue
        d = {k: counts[f"{probe}_probe"][k] - counts[f"{probe}_probe_base"][k]
             for k in ("int", "cvt", "all")}
        cycles = max(d["int"] / 64, d["cvt"] / 16, d["all"] / 128)  # one, on one SM
        if probe == "draw":
            DRAW_SASS = dict(d, sm_cycles=cycles)
            what = "one simulation value (common.cuh:draw_value)"
        else:
            KEY_SASS = dict(d, sm_cycles=cycles)
            what = "one partition key (common.cuh:fold_in)"
        print(f"[draw SASS] {what} compiles to {d['all']} instructions, {d['int']} integer "
              f"and {d['cvt']} conversion or special-function ones: at least {cycles:.3f} SM "
              f"clocks each (the probe {counts[f'{probe}_probe']}, its base "
              f"{counts[f'{probe}_probe_base']})", flush=True)


def draw_floor(sizes, n: int, S: int):
    """The draw's floor of n partitions of S samples: n S d values at
    DRAW_SASS's clocks a value, spread over SM_COUNT SMs at SM_CLOCK_HZ
    (the fp32 bound does not count it); None where the SASS was not
    counted."""
    if DRAW_SASS is None:
        return None
    values = n * S * sizes[0]
    return dict(values=values, int_ops=values * DRAW_SASS["int"],
                ms=values * DRAW_SASS["sm_cycles"] / (SM_COUNT * SM_CLOCK_HZ) * 1e3)


def crown_flops(sizes) -> int:
    """fp32 flops of one role box's CROWN bounds + output forms (KB), an
    FMA counted as 2.  IBP: 4 FMAs per weight.  Each step of layer k's
    backward pass through layer j, with a (rows x cols) coefficient matrix:
    the relaxation, 6 FMAs and 2 products per coefficient, and the product
    with W_j, 2 * in_j * rows * cols FMAs.  The concretization over the
    role box: 4 FMAs per (input, column)."""
    d, outs = sizes[0], sizes[1:]
    ins = sizes[:-1]
    total = sum(8 * a * b for a, b in zip(ins, outs))
    for k in range(1, len(outs)):
        cols = outs[k]
        for j in range(k - 1, -1, -1):
            rows = outs[j]
            total += 14 * rows * cols + 4 * ins[j] * rows * cols
        total += 8 * d * cols
    return total


def forward_near(net, x, masks, rel=TOL_REL, tol_abs=TOL_ABS):
    """Per layer, where the forward of ``x`` (..., d) under ``masks`` has a
    pre-activation within tolerance of 0: ``|z| <= rel * (|h| @ |W| +
    |b|) + tol_abs``, the scale of the sum's f32 rounding.  Only there may
    a kernel and its plain version, which sum in different orders, disagree
    on the sign of z."""
    import torch

    h, near = x, []
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, masks)):
        z = h @ w + b
        near.append(z.abs() <= rel * (h.abs() @ w.abs() + b.abs()) + tol_abs)
        h = z if i == net.depth - 1 else torch.relu(z) * m
    return near


def sample_near(net, keys, lo, hi, sim_size: int, alive=None):
    """Near-zero counts over each partition's simulation samples.

    Without ``alive``: per layer, (N, n_l) counts of samples whose
    pre-activation in the net's own forward lies near 0 (KA's activation
    counts may differ by at most that).  With ``alive``: (N,) counts of
    samples on which the original or the alive-masked logit lies near 0
    (KD's agreement counts may differ by at most that)."""
    import torch

    from fairify_tpu_torch.ops.simulate import PLAIN_ROWS
    from fairify_tpu_torch.utils.prng import simulate_boxes

    parts = []
    for s in range(0, lo.shape[0], PLAIN_ROWS):
        e = s + PLAIN_ROWS
        sim = simulate_boxes(keys[s:e], lo[s:e], hi[s:e], sim_size)
        near = forward_near(net, sim, list(net.masks))
        if alive is None:
            parts.append([n.sum(dim=1) for n in near])
            continue
        masked = [a[s:e, None, :] for a in alive] + [net.masks[-1]]
        either = near[-1] | forward_near(net, sim, masked)[-1]
        parts.append(either[..., 0].sum(dim=1))
    if alive is not None:
        return torch.cat(parts)
    return [torch.cat([p[l] for p in parts]) for l in range(net.depth)]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def case_inputs(name: str, net, cfg, canary: bool = True, seg: int = 0):
    """The main path's own inputs for one prune/stage-0/parity segment,
    the ``seg``-th (``canary``: with the integrity canary chunk, as the
    mega path runs it; without, as one chunk of the chunk loop)."""
    import numpy as np
    import torch

    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.utils.prng import grid_keys
    from fairify_tpu_torch.verify import engine, sweep
    from fairify_tpu_torch.verify.property import encode

    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    step, segs = grid_mod.segment_spans(len(lo), cfg.grid_chunk, cfg.mega_chunks)
    seg_s, seg_e, chunks = segs[seg]
    dev = net.device
    n = seg_e - seg_s
    ka = dict(keys=grid_keys(cfg.seed, seg_s, n, device=dev),
              lo=torch.as_tensor(lo[seg_s:seg_e].astype(np.float32), device=dev),
              hi=torch.as_tensor(hi[seg_s:seg_e].astype(np.float32), device=dev),
              ok=torch.ones(n, dtype=torch.bool, device=dev))
    (x_lo, x_hi, xp_lo, xp_hi, plo, phi, valid, xr, pr,
     nv) = sweep.mega_chunk_inputs(enc, lo, hi, cfg, chunks, step, 0, canary=canary)
    C, P = valid.shape[:2]
    flat = lambda a: torch.as_tensor(a.reshape((C * P,) + a.shape[2:]), device=dev)
    av, pm, rm = engine.enc_tensors(enc, lo.shape[1])
    on = lambda a: torch.as_tensor(a, device=dev)
    kb = dict(x_lo=flat(x_lo), x_hi=flat(x_hi), xp_lo=flat(xp_lo), xp_hi=flat(xp_hi),
              lo=flat(plo), hi=flat(phi), assign_vals=on(av), pa_mask=on(pm),
              ra_mask=on(rm), eps=float(enc.eps), valid=flat(valid),
              valid_pair=on(enc.valid_pair))
    ok = on((np.arange(P)[None, :] < nv[:, None]).reshape(-1))
    kc = dict(xr=flat(xr), pr=flat(pr), valid=kb["valid"], valid_pair=kb["valid_pair"],
              ok=ok)
    return dict(name=name, ka=ka, kb=kb, kc=kc, n_prune=n, n_boxes=C * P,
                S=cfg.engine.attack_samples, V=enc.n_assign, sim=cfg.sim_size)


def kb_cost(sizes, nb: int, V: int, M: int = 1, alpha_iters: int = 0):
    """(flops, bytes) of one KB launch over ``nb`` boxes and ``M`` models.
    Per box and model: 2V role boxes' CROWN passes and the forms' six d-long
    sums; with α, per role box and iteration two chains forward and back
    through the hidden layers (8 flops per hidden weight) plus the final
    forward (4); the V x V pair stage per form set (12 flops per pair and
    coordinate).  Bytes: the role boxes, boxes and masks read once, each
    model's packed net, and per box and model the certificate, margin and
    score written."""
    d = sizes[0]
    hidden = macs(sizes[:-1])
    ns = 2 if alpha_iters > 0 and len(sizes) > 2 else 1
    per_role = crown_flops(sizes) + 12 * d + (
        alpha_iters * 8 * hidden + 4 * hidden if ns == 2 else 0)
    fl = M * nb * (2 * V * per_role + ns * V * V * 12 * d)
    pbytes = 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    by = nb * (4 * V * d * 4 + 2 * d * 4 + V) + M * (pbytes + nb * (1 + 4 + 4 * d))
    return fl, by


def kc_cost(sizes, nb: int, S: int, V: int, M: int = 1):
    """(flops, bytes) of one KC launch: every model's forward of the
    2 S V candidates of each box; the candidates read once, each model's
    packed net, and per box and model the certificate and margin read and
    the witness, reason and gap written."""
    d = sizes[0]
    pbytes = 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    fl = M * 2 * nb * 2 * S * V * macs(sizes)
    by = nb * (2 * S * V * d * 4 + V + 1) + M * (pbytes + nb * (1 + 4 + 12 + 1 + 4))
    return fl, by


def kb_check(name, net, kb, cert_k, margin_k, cert_p, margin_p, alpha_iters: int = 0):
    """KB against its plain version on one net: the margin agrees to
    TOL_REL of the tied bound's magnitude (the scale the certificate's own
    slack is taken against: the margin is a difference of sums whose terms
    reach it), and the certificate — the margin's sign — may differ only
    where the margin sits on 0 within that tolerance.  Returns ``(max abs
    margin error, certificate differences)``."""
    import torch

    from fairify_tpu_torch.verify import engine

    _, _, _, scale = engine.certify_impl(net, **kb, alpha_iters=alpha_iters,
                                         with_scale=True)
    big = margin_p.abs() >= 3e38
    err_m = tol_ratio(margin_k[~big], margin_p[~big], scale[~big])
    near0 = margin_p.abs() <= TOL_REL * torch.maximum(margin_p.abs(), scale) + TOL_ABS
    cert_bad = int(((cert_k != cert_p) & ~near0).sum())
    if err_m > 1.0 or cert_bad or not torch.equal(big, margin_k.abs() >= 3e38):
        fail(f"{name}: margin error {err_m} x tolerance, certificate mismatches "
             f"away from 0: {cert_bad}")
    err = float((margin_k - margin_p)[~big].abs().max()) if (~big).any() else 0.0
    return err, int((cert_k != cert_p).sum())


def kc_check(name, net, kc, k_out, p_out, margin_p):
    """KC against its plain version on one net (``k_out``/``p_out`` = wit,
    reason, gap, stats; both fed the same certificate and margin).  Gaps are
    logits and agree to TOL_REL of the box's largest |logit|; a box's
    witness (and so its reason) may differ only where a logit of the pair
    that decides it lies near 0 (the earlier of the two sides' first hits);
    the histogram must be the kernel's own margins and gaps bucketed, and
    may differ from the plain one only through a gap near an edge.  Returns
    ``(max abs gap error, witness/reason differences)``."""
    import torch

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.verify import engine

    wit_k, reason_k, gap_k, stats_k = k_out
    wit_p, reason_p, gap_p, _stats_p = p_out
    V = kc["valid"].shape[1]
    lx, lp = engine.attack_logits_plain(net, kc["xr"], kc["pr"])
    lscale = torch.maximum(lx.abs().amax(dim=(1, 2)), lp.abs().amax(dim=(1, 2)))
    err_g = tol_ratio(gap_k, gap_p, lscale)
    diff = (wit_k != wit_p).any(dim=1) | (reason_k != reason_p)
    wit_bad = 0
    if diff.any():
        near_x = forward_near(net, kc["xr"], list(net.masks))[-1][..., 0]
        near_p = forward_near(net, kc["pr"], list(net.masks))[-1][..., 0]
        flat = lambda w, r: torch.where(r >= 2, (w[:, 0] * V + w[:, 1]) * V + w[:, 2],
                                        torch.iinfo(torch.int32).max)
        first = torch.where((flat(wit_k, reason_k) <= flat(wit_p, reason_p))[:, None],
                            wit_k, wit_p).long()
        rows_ = torch.arange(first.shape[0], device=first.device)
        decided_near = (near_x[rows_, first[:, 0], first[:, 1]]
                        | near_p[rows_, first[:, 0], first[:, 2]])
        wit_bad = int((diff & ~decided_near).sum())
    stats_own = engine.chunk_stats(margin_p, gap_k, kc["ok"])
    edges = torch.as_tensor(funnel_mod.EDGES, device=gap_p.device)
    bucket = lambda v: (v[:, None] >= edges[None, :]).sum(dim=1)
    tol_gap = TOL_REL * torch.maximum(gap_p.abs(), lscale) + TOL_ABS
    moved = (bucket(gap_k) != bucket(gap_p)) & kc["ok"]
    off_edge = (gap_p[:, None] - edges[None, :]).abs().amin(dim=1) > tol_gap
    edge_bad = int((moved & off_edge).sum())
    if err_g > 1.0 or wit_bad or edge_bad or not torch.equal(stats_k, stats_own):
        fail(f"{name}: gap error {err_g} x tolerance, witness/reason mismatches away "
             f"from a zero logit {wit_bad}, buckets moved away from an edge "
             f"{edge_bad}, stats match own buckets {torch.equal(stats_k, stats_own)}")
    return float((gap_k - gap_p).abs().max()), int(diff.sum())


# Forced KC geometries (rows a warp tile, warps a block, warps a box): one
# warp a box, groups of two and four, and eight warps on a box of 4-row
# tiles.
KC_FORCES = ((16, 4, 1), (8, 8, 2), (32, 4, 4), (4, 8, 8))


def kc_launch(net, args, live=None, force=None):
    """One KC launch through its launch helper, counted nowhere (``args``:
    attack_flips' xr, pr, valid, valid_pair, cert, margin, ok): the
    (wit, reason, gap, stats, fold) tensors."""
    import torch

    from fairify_tpu_torch.utils import cuda_build
    from fairify_tpu_torch.verify import engine

    live = args[0].shape[0] if live is None else live
    fn, a, out = engine._attack_flips_prepare(net, *args, live, _geometry_force=force)
    cuda_build.check("kc_attack_flips", fn(*a, torch.cuda.current_stream().cuda_stream))
    return out


def kc_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def kc_invariance(name, net, args) -> dict:
    """KC's default launch against its launches under KC_FORCES: wit,
    reason, gap, histogram and fold bit for bit; the time of each."""
    from fairify_tpu_torch.verify import engine

    xr = args[0]
    N, S, V, _ = xr.shape
    sizes = (net.in_dim,) + tuple(net.layer_sizes)
    M = getattr(net, "n_models", 1)
    default = engine.attack_flips_geometry(sizes, S, V, N, M)
    base = kc_launch(net, args)
    times = {}
    for f in KC_FORCES:
        out, ms = timed(lambda: kc_launch(net, args, force=f), 3)
        if not kc_equal(out, base):
            fail(f"KC {name}: the launch under the forced geometry {f} differs from the "
                 f"default ({default['tw']}, {default['warps']}, {default['gw']})")
        times[str(f)] = ms
    print(f"[geometry {name}] KC (tw, warps, gw) default ({default['tw']}, {default['warps']}, "
          f"{default['gw']}), {default['grid']} blocks a model: bit-equal under {KC_FORCES}; "
          f"ms {times}", flush=True)
    return dict(default=[default[k] for k in ("tw", "warps", "gw", "grid")], forced_ms=times)


def kc_library(net, xr, pr, reps: int):
    """The library yardstick of KC: its forward over the same 2 S V N rows
    as a cuBLAS chain (:func:`library_forward`, ``addmm``/``baddbmm``), timed
    by events and device-only (:func:`graph_ms`): ``(ms, device-only ms)``.
    The flip scan has no library call."""
    fn = lambda: (library_forward(net, xr), library_forward(net, pr))
    _, ms = timed(fn, reps)
    return ms, graph_ms(fn, split_launches(ms))


def kc_live(name, net, args, reps: int, lives=(1, 17)) -> dict:
    """KC over ``lives`` live boxes of the batch ``args``: the per-box
    outputs of the live boxes equal the full launch's, the rest box live -
    1's (``engine.fill_past``), the histogram the live ok rows' and the
    fold the live boxes' buffers folded; timed through the wrapper and by
    the C entry point alone."""
    import torch

    from fairify_tpu_torch.verify import engine

    full = kc_launch(net, args)
    cert, ok = args[4], args[6]
    out = {}
    for live in lives:
        part = kc_launch(net, args, live=live)
        want = [engine.fill_past(t, live) for t in full[:3]]
        okl = ok & (torch.arange(ok.shape[0], device=ok.device) < live)
        stats = engine.chunk_stats(args[5], full[2], okl)
        fold = engine.fold_int32(cert[:live], full[0][:live], full[1][:live], stats)
        if not (kc_equal(part[:3], want) and torch.equal(part[3], stats)
                and int(part[4]) == fold):
            fail(f"KC {name}: the launch over {live} live boxes differs from the full "
                 "launch's first rows, its fill, histogram or fold")
        _, ms = timed(lambda: engine.attack_flips(net, *args, live=live), reps)
        split = time_split(lambda: engine.attack_flips(net, *args, live=live),
                           engine._attack_flips_prepare(net, *args, live))
        out[str(live)] = dict(ms=ms, entry_ms=split["entry_ms"])
    print(f"[live rows {name}] KC over {list(lives)} live boxes of {args[0].shape[0]}: equal to "
          f"the full launch's rows and fill; ms (wrapper, entry point alone) "
          f"{ {k: (round(v['ms'], 4), round(v['entry_ms'], 4)) for k, v in out.items()} }",
          flush=True)
    return out


def sim_counts_check(net, keys, lo, hi, S: int, k_out, p_out):
    """KA's simulation statistics (``(candidates, pos_prob)`` per layer)
    against the plain version's: the activation counts (pos_prob * S,
    exact in f32) must be equal except for samples whose pre-activation
    lies within tolerance of 0, and the candidate masks must be the counts'
    own zeros on both sides.  Returns ``(max abs pos_prob error, counts off
    by more than their near-zero samples, candidates inconsistent with
    their counts, neurons whose counts differ)``."""
    import torch

    (cand_k, pos_k), (cand_p, pos_p) = k_out, p_out
    err_pos = max(float((a - b).abs().max()) for a, b in zip(pos_k, pos_p))
    near = sample_near(net, keys, lo, hi, S)
    count = lambda pos: [torch.round(p * S) for p in pos]
    cnt_k, cnt_p = count(pos_k), count(pos_p)
    cnt_bad = sum(int(((a - b).abs() > n).sum()) for a, b, n in zip(cnt_k, cnt_p, near))
    cand_bad = sum(int((c != (n == 0).to(c.dtype)).sum())
                   for cs, ns in ((cand_k, cnt_k), (cand_p, cnt_p))
                   for c, n in zip(cs, ns))
    return err_pos, cnt_bad, cand_bad, sum(int((a != b).sum()) for a, b in zip(cnt_k, cnt_p))


def library_sim_forward(net, sim, alive=None):
    """The masked forward of simulation samples (N, S, d) as a chain of
    cuBLAS products (fp32, TF32 off): ``addmm`` per layer, the hidden
    layers masked by the net's masks or, given ``alive`` (a list of (N,
    n_l) tensors), per partition — the library yardstick of KA's and KD's
    simulation (rows 1, 2, 10, 11), which the port never calls."""
    import torch

    N, S, d = sim.shape
    h = sim.reshape(N * S, d)
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        z = torch.addmm(b, h, w)
        if i == net.depth - 1:
            return z[:, 0].view(N, S)
        z = torch.relu(z)
        h = z * m if alive is None else (z.view(N, S, -1) * alive[i][:, None, :]).view(N * S, -1)


# Forced geometries (rows a warp tile, warps a block, tiles a block; None:
# a partition a block) of KA, row 3 and KD, both regimes: one block a
# partition at both tile widths; blocks of 5 tiles, which span two
# partitions; one tile a block, a partition over T blocks.
SIM_FORCES = ((16, 4, None), (32, 2, None), (16, 8, 5), (32, 1, 1))
SIM_RAGGED_S = 37  # a sim_size whose last tile is ragged at both tile widths
SIM_INVARIANCE_ROWS = 512  # the AC case's partitions the forced launches run
SIM_LIVE = (1, 17)  # live rows of the 2,048-row chunk


def split_launches(ms: float) -> int:
    """time_split's back-to-back launches for a kernel of ``ms`` ms:
    SPLIT_LAUNCHES below a millisecond, else as many as take ~0.3 s (at
    least 10)."""
    return SPLIT_LAUNCHES if ms < 1.0 else max(10, int(300 / ms))


def sim_invariance(name, net, keys, lo, hi, al, S: int) -> dict:
    """KA, row 3 and KD at ``S`` samples on the partitions ``lo``/``hi``
    (``al``: KD's packed alive masks): each default launch equal
    (torch.equal) to its launches under SIM_FORCES — KA's cand, pos, wslb,
    wsub and loos (one output buffer), row 3's cand and pos, KD's parity —
    and row 3's output to KA's cand and pos.  Returns, per kernel, the
    default geometry (tw, warps, tiles a block, grid) and the forced
    launches' ms."""
    import torch

    from fairify_tpu_torch.utils import cuda_build
    from fairify_tpu_torch.verify import pruning

    n = lo.shape[0]
    sizes = tuple([net.in_dim] + list(net.layer_sizes))
    res, outs = {}, {}
    for kind in pruning.SIM_KINDS:
        kw = dict(alive=al) if kind == "kd" else {}
        outs[kind] = pruning._sim_launch(net, keys, lo, hi, S, n, kind, **kw)
        geo = pruning.sim_geometry(sizes, n, S, cuda_build.sm_count(lo.device), kind=kind,
                                   regs=pruning.sim_regs(kind))
        times = {}
        for tw, warps, tpb in SIM_FORCES:
            T = -(-S // tw)
            f = (tw, warps, T if tpb is None else min(tpb, T))
            o, times[str(f)] = timed(lambda: pruning._sim_launch(
                net, keys, lo, hi, S, n, kind, _geometry_force=f, **kw), 1)
            if not torch.equal(o, outs[kind]):
                fail(f"{kind} {name} S={S}: the outputs under forced geometry {f} (tile rows, "
                     "warps, tiles a block) differ from the default launch's")
        res[kind] = dict(default=[geo["tw"], geo["warps"], geo["tpb"], geo["grid"]],
                         forced_ms=times)
    nsum = sum(sizes[1:])
    if not torch.equal(outs["stats"], outs["ka"][:, :2 * nsum]):
        fail(f"row 3 {name} S={S}: cand and pos differ from KA's")
    print(f"[geometry {name} S={S}] sim_and_bounds, sim_stats, parity over {n} partitions: "
          f"bit-equal under forced (tile rows, warps, tiles a block) "
          f"{[list(f) for f in SIM_FORCES]} to their defaults "
          f"{ {k: r['default'] for k, r in res.items()} } (registers a thread as built "
          f"{ {k: pruning.sim_regs(k) for k in pruning.SIM_KINDS} }); row 3 = KA's cand, pos; ms "
          f"{ {k: r['forced_ms'] for k, r in res.items()} }", flush=True)
    return res


def sim_live(name, net, keys, lo, hi, al, S: int) -> dict:
    """KA, row 3 and KD over SIM_LIVE live rows of the B rows
    ``lo``/``hi``: the live rows equal the full launch's bit for bit, the
    rows past them row live - 1's.  Returns, per kernel and live count, the
    launch's ms beside the full launch's."""
    import torch

    from fairify_tpu_torch.verify import pruning

    B = lo.shape[0]
    res = {}
    for kind in pruning.SIM_KINDS:
        kw = dict(alive=al) if kind == "kd" else {}
        full, full_ms = timed(lambda: pruning._sim_launch(net, keys, lo, hi, S, B, kind, **kw), 3)
        res[kind] = dict(full_ms=full_ms)
        for live in SIM_LIVE:
            part, ms = timed(lambda: pruning._sim_launch(net, keys, lo, hi, S, live, kind, **kw),
                             3)
            if not torch.equal(part[:live], full[:live]) or not torch.equal(
                    part[live:], part[live - 1:live].expand_as(part[live:])):
                fail(f"{kind} {name}: the launch over {live} of {B} rows differs from the full "
                     "launch, or its rows past them from row live - 1")
            res[kind][str(live)] = ms
    print(f"[live rows {name}] sim_and_bounds, sim_stats, parity over {list(SIM_LIVE)} of {B} "
          f"rows equal the full launch's; ms {res}", flush=True)
    return res


def check_kernels(case, net, reps: int, invariance: bool = False, live: bool = False):
    """Run KA–KD and their plain versions on one case; returns per-kernel
    rows (KA's, KC's and KD's with the library forward of the same samples
    or candidates and the time split of their C entry points).
    ``invariance``: KA, row 3 and KD bit-equal under SIM_FORCES on the
    case's first SIM_INVARIANCE_ROWS partitions, at its sim_size and at
    SIM_RAGGED_S; ``live``: their launches over SIM_LIVE live rows of the
    case's rows (:func:`sim_live`); with either, KC bit-equal under
    KC_FORCES."""
    import torch

    from fairify_tpu_torch.ops import masks as mask_ops
    from fairify_tpu_torch.utils.prng import simulate_boxes
    from fairify_tpu_torch.verify import engine, pruning, sweep

    sizes = [net.in_dim] + list(net.layer_sizes)
    nsum, L, d = sum(sizes[1:]), len(sizes) - 1, sizes[0]
    pbytes = 4 * (macs(sizes) + 2 * nsum)
    rows = {}
    ka, kb, kc, S_sim = case["ka"], case["kb"], case["kc"], case["sim"]

    # --- KA
    k_out, k_ms = timed(lambda: pruning.sim_and_bounds(net, ka["keys"], ka["lo"],
                                                      ka["hi"], ka["ok"], S_sim), reps)
    p_out, p_ms = timed(lambda: pruning.sim_and_bounds_plain(
        net, ka["keys"], ka["lo"], ka["hi"], ka["ok"], S_sim), 1)
    cand_k, pos_k, lb_k, ub_k, loos_k = k_out
    cand_p, pos_p, lb_p, ub_p, loos_p = p_out
    err_pos, cnt_bad, cand_bad, near_diffs = sim_counts_check(
        net, ka["keys"], ka["lo"], ka["hi"], S_sim, (cand_k, pos_k), (cand_p, pos_p))
    # Bounds: TOL_REL of the neuron's interval magnitude (sign-split sums
    # cancel on wide boxes; the widening slack is taken on the same scale).
    err_b = max(tol_ratio(a, b, torch.maximum(lo.abs(), hi.abs()))
                for a, b, lo, hi in zip(lb_k + ub_k, lb_p + ub_p, lb_p + lb_p,
                                        ub_p + ub_p))
    err_abs_b = max(float((a - b).abs().max()) for a, b in zip(lb_k + ub_k, lb_p + ub_p))
    if cnt_bad or cand_bad or err_b > 1.0:
        fail(f"KA {case['name']}: activation counts off by more than their "
             f"near-zero samples on {cnt_bad} neurons, candidates inconsistent "
             f"with counts on {cand_bad}, bound error {err_b} x tolerance")
    n = case["n_prune"]
    fl = 2 * n * S_sim * macs(sizes) + 8 * n * macs(sizes)
    by = n * (8 + 8 * d) + pbytes + n * (16 * nsum + 4 * L)
    sim = simulate_boxes(ka["keys"], ka["lo"], ka["hi"], S_sim)
    _, lib_ka = timed(lambda: library_sim_forward(net, sim), reps)
    split = time_split(lambda: pruning.sim_and_bounds(net, ka["keys"], ka["lo"], ka["hi"],
                                                      ka["ok"], S_sim),
                       pruning._sim_prepare(net, ka["keys"], ka["lo"], ka["hi"], S_sim, n, "ka"),
                       split_launches(k_ms))
    split["library_device_ms"] = graph_ms(lambda: library_sim_forward(net, sim),
                                          split_launches(lib_ka))
    rows["sim_and_bounds"] = dict(max_abs_err=max(err_pos, err_abs_b), ms=k_ms,
                                  plain_ms=p_ms, library_ms=lib_ka, flops=fl, bytes=by,
                                  near_diffs=near_diffs, time_split=split,
                                  draw=draw_floor(sizes, n, S_sim))

    # --- KB
    (cert_k, _score_k, margin_k), kb_ms = timed(lambda: engine.stage0_certify(net, **kb),
                                                reps)
    (cert_p, _score_p, margin_p), kbp_ms = timed(lambda: engine.certify_impl(net, **kb), 1)
    err_m, cert_diffs = kb_check(f"KB {case['name']}", net, kb, cert_k, margin_k, cert_p,
                                 margin_p)
    nb, V = case["n_boxes"], case["V"]
    fl, by = kb_cost(sizes, nb, V)
    rows["stage0_certify"] = dict(max_abs_err=err_m, ms=kb_ms, plain_ms=kbp_ms, flops=fl,
                                  bytes=by, near_diffs=cert_diffs)

    # --- KC (fed the plain certificate so both sides see identical inputs)
    args = (kc["xr"], kc["pr"], kc["valid"], kc["valid_pair"], cert_p, margin_p, kc["ok"])
    k_res, kc_ms = timed(lambda: engine.attack_flips(net, *args), reps)
    p_res, kcp_ms = timed(lambda: engine.attack_flips_plain(net, *args), 1)
    err_g, wit_diffs = kc_check(f"KC {case['name']}", net, kc, k_res[:4], p_res[:4],
                                margin_p)
    # The fold is the kernel's own buffers folded with wraparound.
    fold_own = engine.fold_int32(cert_p, k_res[0], k_res[1], k_res[3])
    if k_res[4] != fold_own:
        fail(f"KC {case['name']}: fold {k_res[4]} vs own {fold_own} vs plain {p_res[4]}")
    fl, by = kc_cost(sizes, nb, case["S"], V)
    lib_kc, lib_kc_dev = kc_library(net, kc["xr"], kc["pr"], reps)
    split = time_split(lambda: engine.attack_flips(net, *args),
                       engine._attack_flips_prepare(net, *args, nb), split_launches(kc_ms))
    split["library_device_ms"] = lib_kc_dev
    rows["attack_flips"] = dict(max_abs_err=err_g, ms=kc_ms, plain_ms=kcp_ms, flops=fl,
                                bytes=by, near_diffs=wit_diffs, library_ms=lib_kc,
                                time_split=split)
    if invariance or live:
        rows["attack_flips"]["geometry"] = kc_invariance(case["name"], net, args)

    # --- KD (alive masks from the KA bound-dead masks, as the sweep does)
    ibp_dead = [(u <= 0).to(torch.float32) for u in ub_p[:-1]]
    dead = mask_ops.keep_one_alive([(c * dd).cpu().numpy()
                                    for c, dd in zip(cand_p[:-1], ibp_dead)])
    alive = [torch.as_tensor(1.0 - dd, device=net.device) for dd in dead]
    par_k, kd_ms = timed(lambda: sweep.parity(net, ka["keys"], ka["lo"], ka["hi"],
                                              alive, S_sim), reps)
    par_p, kdp_ms = timed(lambda: sweep.parity_plain(net, ka["keys"], ka["lo"],
                                                     ka["hi"], alive, S_sim), 1)
    err_par = float((par_k - par_p).abs().max())
    # Agreement counts (parity * S) must be equal except for samples whose
    # original or masked logit lies within tolerance of 0.
    near_par = sample_near(net, ka["keys"], ka["lo"], ka["hi"], S_sim, alive)
    par_bad = int(((torch.round(par_k * S_sim) - torch.round(par_p * S_sim)).abs()
                   > near_par).sum())
    if par_bad:
        fail(f"KD {case['name']}: agreement counts off by more than their "
             f"near-zero logits on {par_bad} partitions (max err {err_par})")
    # Two forwards per sample that share layer 0's pre-activation.
    fl = 2 * n * S_sim * (2 * macs(sizes) - sizes[0] * sizes[1])
    by = n * (8 + 8 * d + 4 * (nsum - 1) + 4) + pbytes
    lib_kd_fn = lambda: (library_sim_forward(net, sim), library_sim_forward(net, sim, alive))
    _, lib_kd = timed(lib_kd_fn, reps)
    lib_kd_dev = graph_ms(lib_kd_fn, split_launches(lib_kd))
    del sim, lib_kd_fn
    al = torch.cat(alive, dim=1).contiguous()
    split = time_split(lambda: sweep.parity(net, ka["keys"], ka["lo"], ka["hi"], alive, S_sim),
                       pruning._sim_prepare(net, ka["keys"], ka["lo"], ka["hi"], S_sim, n, "kd",
                                            alive=al), split_launches(kd_ms))
    split["library_device_ms"] = lib_kd_dev
    rows["parity"] = dict(max_abs_err=err_par, ms=kd_ms, plain_ms=kdp_ms, library_ms=lib_kd,
                          flops=fl, bytes=by, near_diffs=int((par_k != par_p).sum()),
                          time_split=split, draw=draw_floor(sizes, n, S_sim))
    if invariance:
        m = min(n, SIM_INVARIANCE_ROWS)
        sub = lambda t: t[:m].contiguous()
        rows["sim_and_bounds"]["geometry"] = {
            str(S): sim_invariance(case["name"], net, sub(ka["keys"]), sub(ka["lo"]),
                                   sub(ka["hi"]), sub(al), S)
            for S in (S_sim, SIM_RAGGED_S)}
    if live:
        rows["sim_and_bounds"]["live_rows"] = sim_live(case["name"], net, ka["keys"], ka["lo"],
                                                       ka["hi"], al, S_sim)
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["flops"], r["bytes"])
        lib = r.get("library_ms")
        sp = r.get("time_split")
        dr = r.get("draw")
        print(f"[kernel {case['name']}] {name}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms{'' if lib is None else f', library {lib:.4f} ms'}, "
              f"bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}"
              + ("" if sp is None else f"; C entry point alone {sp['entry_ms']:.4f} ms, "
                 f"wrapper share {sp['wrapper_share']:.2f}, library chain device-only "
                 f"{fmt_ms(sp.get('library_device_ms'))} (CUDA graph replays)")
              + ("" if "draw" not in r else f"; the draw's floor from its SASS "
                 f"{fmt_ms(None if dr is None else dr['ms'])}")
              + f", max_abs_err {r['max_abs_err']:.3g}, discrete "
              f"outputs differing near a threshold {r['near_diffs']})", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 2b: the refinement kernels (K5, K6) against their plain versions
# ---------------------------------------------------------------------------


def leftovers(net, cfg, n, span: int):
    """The first ``n`` (None: all) boxes of the grid's first ``span``
    partitions that stage 0 (KB + KC, as the sweep runs them) leaves
    undecided: (enc, lo, hi) int64."""
    import numpy as np

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.verify import sweep
    from fairify_tpu_torch.verify.property import encode

    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    lo, hi = lo[:span], hi[:span]
    unsat, sat, _ = sweep.stage0_certify_and_attack(
        net, enc, lo, hi, cfg, stats=funnel_mod.StageStats(), failed={})
    left = np.where(~unsat & ~sat)[0][:n]
    if n is not None and len(left) < n:
        fail(f"{cfg.name}: only {len(left)} stage-0 leftovers in {span} partitions")
    return enc, lo[left], hi[left]


def sign_unstable(g32, g64):
    """Components whose sign f32 rounding can move: the f32 and f64 values
    differ in sign, or the f64 value is within 16 times their difference
    (the observed rounding, with room for a kernel that sums in another
    order).  Components exactly zero in both are structural, not near."""
    g32 = g32.double()
    both_zero = (g32 == 0) & (g64 == 0)
    return ~both_zero & ((g32.sign() != g64.sign())
                         | (g64.abs() <= 16 * (g32 - g64).abs()))


def pgd_near(net, args, key, steps, restarts):
    """Run K5's plain version and mark each trajectory (B, R) whose path
    met a threshold at some step, where a kernel that sums in another order
    may take another turn: a pre-activation within the path band of 0 (the
    ReLU derivative), the objective's two sides or two tied maxima within
    that band, or a gradient component whose sign f32 rounding can move
    (:func:`sign_unstable`, against the same step in float64).  Returns
    (plain outputs, near)."""
    import copy

    import torch

    from fairify_tpu_torch.verify import engine

    lo, hi, av, pm, rm, valid, eps = args
    near = torch.zeros(lo.shape[0], restarts, dtype=torch.bool, device=lo.device)
    vm = valid[:, None, :]
    net64 = copy.deepcopy(net).double()
    big = torch.tensor(3e38, dtype=torch.float64, device=lo.device)

    def close(a, b):
        return (a - b).abs() <= PATH_REL * torch.maximum(a.abs(), b.abs()) + PATH_ABS

    def grad64(x, xp):
        x64 = x.double().requires_grad_(True)
        xp64 = xp.double().requires_grad_(True)
        with torch.enable_grad():
            fxm = torch.where(vm, net64(x64), -big).amax(-1)
            fpm = torch.where(vm, net64(xp64), big).amin(-1)
            gx, gp = torch.autograd.grad(torch.minimum(fxm, -fpm).sum(), (x64, xp64))
        sh = (1.0 - pm).double()
        return ((gx + gp) * sh).sum(-2), (gp * rm.double()).sum(-2)

    def on_step(x, xp, g_s, g_r):
        nonlocal near
        for pts in (x, xp):
            for n in forward_near(net, pts, list(net.masks), PATH_REL, PATH_ABS):
                near |= (n.any(-1) & vm).any(-1)
        fx = torch.where(vm, net(x), torch.tensor(-3e38, device=x.device))
        fp = torch.where(vm, net(xp), torch.tensor(3e38, device=x.device))
        top_x, top_p = fx.topk(min(2, fx.shape[-1]), -1), (-fp).topk(min(2, fp.shape[-1]), -1)
        near |= close(top_x.values[..., 0], top_p.values[..., 0])
        if fx.shape[-1] > 1:
            near |= close(top_x.values[..., 0], top_x.values[..., 1])
            near |= close(top_p.values[..., 0], top_p.values[..., 1])
        gs64, gr64 = grad64(x, xp)
        near |= sign_unstable(g_s * (1.0 - pm), gs64).any(-1)
        near |= sign_unstable(g_r * rm, gr64).any(-1)

    out = engine.pgd_attack_plain(net, *args, key, steps, restarts, on_step=on_step)
    return out, near


def pgd_verdict(net, k_out, p_out, near, valid):
    """Why K5's outputs fail against the plain version's on the same
    inputs, or None.  A trajectory may end at another point only where the
    plain path met a threshold (``near``), and at most PGD_DIFF_SHARE of
    them may; where the points agree, the logits agree to the tolerance of
    their own sums.  Returns (why, same) with ``same`` the (B, R) map of
    trajectories ending at the plain version's points."""
    fx_k, fp_k, x_k, xp_k = k_out
    fx_p, fp_p, x_p, xp_p = p_out
    same = (x_k == x_p).all(-1).all(-1) & (xp_k == xp_p).all(-1).all(-1)
    n_diff, bad = int((~same).sum()), int((~same & ~near).sum())
    vm = valid[:, None, :].expand_as(fx_p)[same]
    err = max(tol_ratio(fx_k[same][vm], fx_p[same][vm], logit_scale(net, x_p)[same][vm]),
              tol_ratio(fp_k[same][vm], fp_p[same][vm], logit_scale(net, xp_p)[same][vm]))
    if bad:
        return f"{bad} trajectories end elsewhere without a threshold on their path", same
    if n_diff > PGD_DIFF_SHARE * same.numel():
        return (f"{n_diff} of {same.numel()} trajectories end elsewhere, more than "
                f"{PGD_DIFF_SHARE:g} of them"), same
    if err > 1.0:
        return f"logit error {err} x tolerance", same
    return None, same


def pgd_mutant(name, k_out, same, near, pa_mask):
    """A copy of K5's outputs with the first shared coordinate of one
    trajectory that met no threshold (and ended at the plain version's
    point) shifted by one: :func:`pgd_verdict` must fail it."""
    import torch

    clean = torch.nonzero(same & ~near)
    if clean.shape[0] == 0:
        fail(f"K5 {name}: every trajectory met a threshold; the check is vacuous")
    b, r = (int(v) for v in clean[0])
    x_m = k_out[2].clone()
    x_m[b, r, :, int(torch.nonzero(1.0 - pa_mask)[0, 0])] += 1.0
    return k_out[0], k_out[1], x_m, k_out[3]


def check_pgd(name, net, enc, lo, hi, reps: int, steps: int, restarts: int,
              mutate: bool = False):
    """K5 against its plain version on one batch of boxes
    (:func:`pgd_verdict`), after ``steps`` steps and again after 0 (the
    rounded threefry starts, equal everywhere), 1 and 4 steps.  With
    ``mutate``, a copy of the kernel's output with one point of a
    trajectory that met no threshold shifted by one must fail."""
    import torch

    from fairify_tpu_torch.utils import prng
    from fairify_tpu_torch.verify import engine

    args, _ = engine.pgd_inputs(enc, lo, hi, net.device)
    valid = args[5]
    key = prng.seed_key(1234, device=net.device)
    run = lambda n: engine.pgd_attack_kernel(net, *args, key, n, restarts)
    k_out, k_ms = timed(lambda: run(steps), reps)
    (p_out, near), p_ms = timed(lambda: pgd_near(net, args, key, steps, restarts), 1)
    why, same = pgd_verdict(net, k_out, p_out, near, valid)
    if why:
        fail(f"K5 {name}, {steps} steps: {why}")
    if mutate and pgd_verdict(net, pgd_mutant(name, k_out, same, near, args[3]), p_out,
                              near, valid)[0] is None:
        fail(f"K5 {name}: a point shifted by one passes the check")
    near_short = {}
    for short in (0, 1, 4):
        ps, nears = pgd_near(net, args, key, short, restarts)
        if short == 0:
            nears = torch.zeros_like(nears)
        why, _ = pgd_verdict(net, run(short), ps, nears, valid)
        if why:
            fail(f"K5 {name}, {short} steps: {why}")
        near_short[short] = int(nears.sum())
    fx_k, fp_k, x_k, xp_k = k_out
    fx_p, fp_p, x_p, xp_p = p_out
    B, R, V, d = x_p.shape
    sizes = [net.in_dim] + list(net.layer_sizes)
    fl = B * R * 2 * V * (steps * 4 * macs(sizes) + 2 * macs(sizes))
    by = B * (2 * d * 4 + V) + 4 * (macs(sizes) + 2 * sum(sizes[1:])) + B * R * V * (2 + 2 * d) * 4
    row = dict(max_abs_err=float((torch.cat([fx_k[same], fp_k[same]])
                                  - torch.cat([fx_p[same], fp_p[same]])).abs().max())
                                  if same.any() else 0.0,
               ms=k_ms, plain_ms=p_ms, flops=fl, bytes=by,
               near_diffs=int((~same).sum()))
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel {name}] pgd_attack B={B} R={R}: {k_ms:.3f} ms (plain {p_ms:.3f} ms, "
          f"bound {row['bound_ms']:.3f} ms by {row['bound_by']}; trajectories "
          f"ending elsewhere near a threshold {row['near_diffs']} of {B * R}; "
          f"near-threshold paths {int(near.sum())} in {steps} steps, "
          f"{near_short[1]} in 1, {near_short[4]} in 4"
          f"{'; a shifted point fails the check' if mutate else ''})", flush=True)
    return row


RETRY_BOXES = 32


def check_pgd_retry(name, net, enc, lo, hi, steps: int, restarts: int):
    """K5 at the heuristic retry's shape: RETRY_BOXES launches of one box
    each (B = 1, as ``decide_box`` → Phase A runs it), each with its own
    key, against the plain version's run of the same box and key; the
    RETRY_BOXES x restarts trajectories are judged together by
    :func:`pgd_verdict` (PGD_DIFF_SHARE of all of them).  Each launch timed
    once after a warm-up; the median is the row's time."""
    import torch

    from fairify_tpu_torch.utils import prng
    from fairify_tpu_torch.verify import engine

    k_outs, p_outs, nears, valids, times = [], [], [], [], []
    for b in range(RETRY_BOXES):
        args, _ = engine.pgd_inputs(enc, lo[b:b + 1], hi[b:b + 1], net.device)
        key = prng.seed_key(5000 + b, device=net.device)
        run = lambda: engine.pgd_attack_kernel(net, *args, key, steps, restarts)
        out, ms = timed(run, 1)
        (p_out, near), p_ms = timed(lambda: pgd_near(net, args, key, steps, restarts), 1)
        k_outs.append(out)
        p_outs.append(p_out)
        nears.append(near)
        valids.append(args[5])
        times.append(ms)
    cat = lambda outs: tuple(torch.cat(t) for t in zip(*outs))
    k_out, p_out, near, valid = cat(k_outs), cat(p_outs), torch.cat(nears), torch.cat(valids)
    why, same = pgd_verdict(net, k_out, p_out, near, valid)
    if why:
        fail(f"K5 {name}, {RETRY_BOXES} single-box launches: {why}")
    if pgd_verdict(net, pgd_mutant(name, k_out, same, near, args[3]), p_out, near,
                   valid)[0] is None:
        fail(f"K5 {name}, single-box launches: a point shifted by one passes the check")
    sizes = [net.in_dim] + list(net.layer_sizes)
    V, d = valid.shape[1], lo.shape[1]
    fl = restarts * 2 * V * (steps * 4 * macs(sizes) + 2 * macs(sizes))
    by = (2 * d * 4 + V) + 4 * (macs(sizes) + 2 * sum(sizes[1:])) + restarts * V * (2 + 2 * d) * 4
    ms = sorted(times)[len(times) // 2]
    row = dict(ms=ms, plain_ms=p_ms, boxes=RETRY_BOXES, trajectories=int(same.numel()),
               near_diffs=int((~same).sum()), flops=fl, bytes=by,
               max_abs_err=float((torch.cat([k_out[0][same], k_out[1][same]])
                                  - torch.cat([p_out[0][same], p_out[1][same]])).abs().max())
               if same.any() else 0.0)
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel {name}] pgd_attack B=1 R={restarts}, {RETRY_BOXES} launches: median "
          f"{ms:.4f} ms (min {min(times):.4f}, max {max(times):.4f}; plain {p_ms:.3f} ms; "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}); "
          f"{int(same.numel())} trajectories checked together, {row['near_diffs']} end "
          f"elsewhere near a threshold; a shifted point fails the check", flush=True)
    return row


def pgd_invariance(name, net, enc, lo, hi, steps: int, restarts: int) -> dict:
    """K5's outputs at one trajectory per warp tile and one warp per block
    (TT = 1) and at the largest tile (the most trajectories a warp tile
    holds, every warp shared memory holds) must be bit-equal: a
    trajectory's arithmetic does not depend on the tile, warp or block that
    carries it.  Uses the launch helper's private ``_geometry_force``."""
    import torch

    from fairify_tpu_torch.utils import prng
    from fairify_tpu_torch.verify import engine

    args, _ = engine.pgd_inputs(enc, lo, hi, net.device)
    key = prng.seed_key(77, device=net.device)
    sizes = [net.in_dim] + list(net.layer_sizes)
    big = engine.pgd_geometry(sizes, 1 << 30, args[2].shape[0])
    geos = {"TT=1": (1, 1), "largest": (big["ttw"], big["warps"])}
    outs = {k: engine._pgd_attack_launch(net, *args, key, steps, restarts, _geometry_force=g)
            for k, g in geos.items()}
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs["TT=1"], outs["largest"])):
        fail(f"K5 {name}: the outputs at (ttw, warps) {geos['TT=1']} and "
             f"{geos['largest']} differ")
    print(f"[geometry {name}] pgd_attack B={lo.shape[0]} R={restarts}, {steps} steps, at "
          f"(ttw, warps) {geos['TT=1']} and {geos['largest']}: bit-equal", flush=True)
    return {k: list(g) for k, g in geos.items()}


def logit_scale(net, x):
    """The rounding scale |h| @ |W| + |b| of the logit at points x."""
    import torch

    h = x
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        z = h @ w + b
        if i == net.depth - 1:
            return (h.abs() @ w.abs() + b.abs())[..., 0]
        h = torch.relu(z) * m


def bab_queue(net, enc, lo, hi, Q: int):
    """The first root group's slot queue, as ``engine.device_bab_phase``
    builds it (capacity Q plus the canary slot, G = Q // 4 roots)."""
    import numpy as np
    import torch

    from fairify_tpu_torch.verify import engine

    d, V, G = lo.shape[1], enc.n_assign, max(1, Q // 4)
    Qs = Q + 1
    q = {"q_lo": np.zeros((Qs, d), np.float32), "q_hi": np.zeros((Qs, d), np.float32),
         "q_root": np.zeros(Qs, np.int32), "q_live": np.zeros(Qs, bool),
         "found": np.zeros(Qs, bool), "wit_a": np.zeros(Qs, np.int32),
         "wit_b": np.zeros(Qs, np.int32), "wit_pt": np.zeros((Qs, d), np.float32)}
    g = min(G, lo.shape[0])
    q["q_lo"][:g], q["q_hi"][:g] = lo[:g], hi[:g]
    q["q_root"][:g] = np.arange(g)
    q["q_live"][:g] = True
    pa = np.asarray(enc.pa_idx)
    root_valid = np.zeros((G, V), bool)
    root_valid[:g] = ((enc.assignments[None] >= lo[:g, None, pa])
                      & (enc.assignments[None] <= hi[:g, None, pa])).all(-1)
    slot_ok = np.ones(Qs, bool)
    slot_ok[-1] = False
    bm = np.zeros(d, np.float32)
    bm[engine._branch_dims(enc, d)] = 1.0
    av, pm, rm = engine.enc_tensors(enc, d)
    on = lambda a: torch.as_tensor(a, device=net.device)
    consts = dict(slot_ok=on(slot_ok), root_valid=on(root_valid), assign_vals=on(av),
                  pa_mask=on(pm), ra_mask=on(rm), eps=float(enc.eps),
                  valid_pair=on(enc.valid_pair), branch_mask=on(bm))
    return {k: on(v) for k, v in q.items()}, consts


def seg_args(st, c):
    return (st["q_lo"], st["q_hi"], st["q_root"], st["q_live"], st["found"],
            st["wit_a"], st["wit_b"], st["wit_pt"], c["slot_ok"], c["root_valid"],
            c["assign_vals"], c["pa_mask"], c["ra_mask"], c["eps"], c["valid_pair"],
            c["branch_mask"])


def bab_verdict(seg, plain):
    """Why a K6 segment fails against the plain version's on the same
    queue, or None: every queue buffer and per-root counter must be equal
    (on these inputs no slot decision sits on a threshold: the queue
    carries integer box bounds, so an f32 difference in a bound changes a
    decision only there), and the device fold must be the host fold of the
    kernel's buffers."""
    import torch

    from fairify_tpu_torch.resilience import integrity
    from fairify_tpu_torch.verify import engine

    keys = integrity.BAB_FOLD_KEYS
    differ = [k for k in keys if not torch.equal(seg[k], plain[k])]
    if differ:
        return f"the segment differs from the plain version's in {differ}"
    if seg["csum"] != engine.fold_int32(*(seg[k] for k in keys)):
        return "the device fold differs from the host fold"
    return None


def bab_mutants(seg):
    """Copies of a K6 segment, each with one latch, counter or slot bound
    shifted by one (and its fold recomputed, so only the comparison with
    the plain version can catch it)."""
    from fairify_tpu_torch.resilience import integrity
    from fairify_tpu_torch.verify import engine

    live = int(seg["q_live"].nonzero()[0, 0]) if seg["q_live"].any() else 0
    shifts = {"found": lambda t: t[live].logical_not_(),
              "nodes": lambda t: t[0].add_(1),
              "splits": lambda t: t[0].add_(1),
              "q_lo": lambda t: t[live, 0].add_(1.0),
              "q_hi": lambda t: t[live, 0].sub_(1.0),
              "q_root": lambda t: t[live].add_(1)}
    for key, shift in shifts.items():
        mut = {k: seg[k].clone() for k in integrity.BAB_FOLD_KEYS}
        shift(mut[key])
        mut["csum"] = engine.fold_int32(*(mut[k] for k in integrity.BAB_FOLD_KEYS))
        yield key, mut


def bab_cost(sizes, V: int, Qs: int, alpha_iters: int, live_rounds: int):
    """(flops, bytes) of one K6 segment that certified ``live_rounds``
    slot-rounds (the segment's ``nodes`` sum): per role box CROWN
    (crown_flops), the form sums (12 d), and per α iteration two chains
    forward and back through the hidden layers (8 flops per hidden
    weight), plus the final forward (4); per slot the pair bounds and the
    probe.  Bytes: the queue read and written once, the net read once."""
    d = sizes[0]
    ns = 2 if alpha_iters > 0 else 1
    hidden = macs(sizes[:-1])
    per_box = crown_flops(sizes) + 12 * d + (alpha_iters * 8 * hidden + 4 * hidden
                                             if alpha_iters > 0 else 0)
    fl = live_rounds * (2 * V * per_box + ns * 2 * V * V * 12 * d + 2 * V * macs(sizes))
    by = 2 * (Qs * (3 * d * 4 + 4 * 3 + 2)) + 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    return fl, by


def check_bab(name, net, st0, c, alpha_iters: int, rounds: int, reps: int,
              mutate: bool = False, plain: bool = True):
    """K6 against its plain version on one queue: one ``rounds``-round
    segment of each (:func:`bab_verdict`).  With ``mutate``, every copy of
    :func:`bab_mutants` must fail; without ``plain`` the kernel is only
    timed.  Returns the kernel row."""
    from fairify_tpu_torch.verify import engine

    live = int(st0["q_live"].sum())
    seg, k_ms = timed(lambda: engine.bab_segment(
        net, *seg_args(st0, c), rounds=rounds, alpha_iters=alpha_iters, live_slots=live),
        reps)
    p_ms = err = None
    if plain:
        ref, p_ms = timed(lambda: engine.bab_segment_plain(
            net, *seg_args(st0, c), rounds=rounds, alpha_iters=alpha_iters), 1)
        why = bab_verdict(seg, ref)
        if why:
            fail(f"K6 {name} alpha={alpha_iters}: {why}")
        if mutate:
            for key, mut in bab_mutants(seg):
                if bab_verdict(mut, ref) is None:
                    fail(f"K6 {name} alpha={alpha_iters}: a segment with {key} shifted "
                         "by one passes the check")
        err = float(max((seg["q_lo"] - ref["q_lo"]).abs().max(),
                        (seg["q_hi"] - ref["q_hi"]).abs().max()))
    sizes = [net.in_dim] + list(net.layer_sizes)
    V = c["assign_vals"].shape[0]
    live_rounds = int(seg["nodes"].sum())  # slot-rounds certified in the segment
    Qs = st0["q_lo"].shape[0]
    fl, by = bab_cost(sizes, V, Qs, alpha_iters, live_rounds)
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, flops=fl, bytes=by,
               live_rounds=live_rounds)
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel {name}] bab_segment alpha={alpha_iters} Qs={Qs} rounds={rounds}: "
          f"{k_ms:.3f} ms ("
          + (f"plain {p_ms:.3f} ms, " if plain else "")
          + f"bound {row['bound_ms']:.3f} ms by {row['bound_by']}; {live_rounds} "
          f"slot-rounds"
          + ("; queue, latches, counters and fold equal to the plain version's" if plain
             else "")
          + ("; every shifted latch, counter or slot fails the check" if mutate else "")
          + ")", flush=True)
    return row


def bab_invariance(name, net, st0, c, alpha_iters: int, rounds: int) -> list:
    """K6 under forced launch geometries (warps a block, blocks an SM):
    every queue buffer, latch, counter and the fold must equal the default
    launch's bit for bit.  Returns the forced geometries."""
    import torch

    from fairify_tpu_torch.resilience import integrity
    from fairify_tpu_torch.utils import cuda_build
    from fairify_tpu_torch.verify import engine

    args = seg_args(st0, c)
    live = int(st0["q_live"].sum())
    base = engine._bab_segment_launch(net, *args, rounds, alpha_iters, live_slots=live)
    sizes = tuple([net.in_dim] + list(net.layer_sizes))
    V, Qs = c["assign_vals"].shape[0], st0["q_lo"].shape[0]
    default = engine.bab_geometry(sizes, V, Qs, cuda_build.sm_count(net.device),
                                  live=live)
    forces = [(4, 1), (default["warps"], 1), (engine.K6_MAX_WARPS, 1)]
    for force in forces:
        seg = engine._bab_segment_launch(net, *args, rounds, alpha_iters,
                                         live_slots=live, _geometry_force=force)
        bad = [k for k in integrity.BAB_FOLD_KEYS if not torch.equal(seg[k], base[k])]
        if bad or seg["csum"] != base["csum"]:
            fail(f"K6 {name} alpha={alpha_iters}: geometry {force} changes {bad or 'the fold'}")
    print(f"[geometry {name}] bab_segment alpha={alpha_iters}: forced (warps, blocks/SM) "
          f"{forces} bit-equal to the default {(default['warps'], default['per_sm'])}",
          flush=True)
    return forces


def k12_floor(values: int, blocks: int):
    """A K12 launch's draw floor: ``values`` at DRAW_SASS's clocks a value
    over the SMs its ``blocks`` occupy (at most SM_COUNT), at SM_CLOCK_HZ;
    None where the SASS was not counted."""
    if DRAW_SASS is None:
        return None
    sms = min(blocks, SM_COUNT)
    return dict(values=values, sms=sms,
                ms=values * DRAW_SASS["sm_cycles"] / (sms * SM_CLOCK_HZ) * 1e3)


def key_floor(n: int):
    """The key kernel's floor: ``n`` keys at KEY_SASS's clocks a key over
    the SMs its 256-key blocks occupy; None where the SASS was not
    counted."""
    if KEY_SASS is None:
        return None
    sms = min(-(-n // 256), SM_COUNT)
    return dict(keys=n, sms=sms, ms=n * KEY_SASS["sm_cycles"] / (sms * SM_CLOCK_HZ) * 1e3)


def check_sim_rows(name, net, cfg, lo, hi, reps: int):
    """K12's row generator against its plain version
    (``prng.simulate_boxes`` of ``prng.fold_in_plain``'s keys, both on the
    card) at the heuristic retry's shape: one partition's ``sim_size`` rows
    from (seed, global index), bit-equal, timed through the wrapper (the
    launch, its copy into pinned host memory and one sync) and by its C
    entry point alone, with and without the copy (``time_split``); then,
    bit-equal, the rows of three boxes — the first partition, the preset's
    whole domain (its widest spans) and the second partition with one
    dimension cut to a single value (span 1): the draw KA, row 3 and KD
    share — at the preset's seed and index 0, at a seed past 2**32 with an
    index past 65,535, and under key words whose high word is not 0.
    Returns the kernel row; its bound is the larger of the bytes and the
    draw's floor over the SMs the launch occupies."""
    import numpy as np
    import torch

    from fairify_tpu_torch.utils import prng
    from fairify_tpu_torch.utils.prng import simulate_boxes
    from fairify_tpu_torch.verify import pruning

    dev, S, d = net.device, cfg.sim_size, lo.shape[1]
    on = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    plain = lambda words, index, l, h: simulate_boxes(
        prng.fold_in_plain(words, index, len(l), dev), on(l), on(h), S).cpu()
    blo, bhi = np.asarray(lo[:1], np.float32), np.asarray(hi[:1], np.float32)
    k_out, k_ms = timed(lambda: pruning.sim_rows(cfg.seed, 0, blo, bhi, S, dev), reps)
    p_out, p_ms = timed(lambda: plain(prng.key_words(cfg.seed), 0, blo, bhi), reps)
    if not torch.equal(k_out, p_out):
        fail(f"K12 sim_rows {name}: {int((k_out != p_out).sum())} sample values "
             "differ from the plain version's")
    dlo, dhi = cfg.query().domain.lo_hi()
    mlo = np.stack([np.asarray(lo[0], np.float32), dlo, np.asarray(lo[1], np.float32)])
    mhi = np.stack([np.asarray(hi[0], np.float32), dhi, np.asarray(hi[1], np.float32)])
    mhi[2, 0] = mlo[2, 0]
    widest = int((dhi - dlo).max()) + 1
    big = (2**32 + cfg.seed, 70_000)
    for seed, index in ((cfg.seed, 0), big):
        mk, mp = (pruning.sim_rows(seed, index, mlo, mhi, S, dev),
                  plain(prng.key_words(seed), index, mlo, mhi))
        if not torch.equal(mk, mp):
            fail(f"K12 sim_rows {name}, seed {seed}, index {index}: the first partition, the "
                 f"whole domain (widest span {widest}) and a box with a span-1 dimension: "
                 f"{int((mk != mp).sum())} values differ")
    words = (0xDEADBEEF, cfg.seed)
    mk = pruning.sim_rows_host(words, 65_536, mlo, mhi, S, dev).clone()
    if not torch.equal(mk, plain(words, 65_536, mlo, mhi)):
        fail(f"K12 sim_rows {name}: key words {words}: the rows differ from the plain "
             "version's")
    lo_i, hi_i = blo.astype(np.int32), bhi.astype(np.int32)
    prep = lambda copy: pruning._sim_rows_prepare(prng.key_words(cfg.seed), 0, lo_i, hi_i, S,
                                                  dev, copy=copy)
    wrapper = lambda: pruning.sim_rows(cfg.seed, 0, blo, bhi, S, dev)
    split = time_split(wrapper, prep(True))
    split["entry_no_copy_ms"] = time_split(wrapper, prep(False))["entry_ms"]
    geo = pruning.sim_rows_geometry(d, S)
    N = k_out.shape[0]
    by = N * (8 + 2 * d * 4) + N * S * d * 4
    row = dict(max_abs_err=float((k_out - p_out).abs().max()), ms=k_ms, plain_ms=p_ms,
               flops=0, bytes=by, time_split=split, geometry=geo,
               draw=k12_floor(N * S * d, geo["grid_x"] * N))
    b_ms, b_by = bound(0, by)
    dr = row["draw"]
    if dr is not None and dr["ms"] > b_ms:
        b_ms, b_by = dr["ms"], "operations"
    row["bound_ms"], row["bound_by"] = b_ms, b_by
    print(f"[kernel {name}] sim_rows N={N} S={S} d={d} ({geo['grid_x']} blocks of "
          f"{geo['rpp']} rows a pass): {k_ms:.4f} ms through the wrapper (launch, copy to "
          f"pinned host memory, sync; plain {p_ms:.4f} ms); C entry point alone "
          f"{split['entry_ms']:.4f} ms with the copy, {split['entry_no_copy_ms']:.4f} ms "
          f"without (the launch latency); bound {row['bound_ms']:.5f} ms by "
          f"{row['bound_by']} (draw floor over {fmt_ms(None if dr is None else dr['ms'])}); "
          f"bit-equal, and on the first partition, the whole domain (widest span {widest}) "
          f"and a box with a span-1 dimension at seeds {cfg.seed} and {big[0]} (index "
          f"{big[1]}) and key words {words}", flush=True)
    return row


def check_grid_keys(name, cfg, n: int, reps: int):
    """K12's key kernel (``prng.grid_keys`` on the card) against its plain
    version (``prng.grid_keys_plain``, the torch threefry, on the card):
    ``n`` keys of a prune or parity segment, bit-equal and timed; bit-equal
    also at a seed past 2**32 from an index past 65,535 and, through
    ``prng.fold_in_launch``, under key words whose high word is not 0.
    Returns the kernel row; its bound is the larger of the output's bytes
    and the keys' integer floor from the SASS."""
    import torch

    from fairify_tpu_torch.utils import prng

    k_out, k_ms = timed(lambda: prng.grid_keys(cfg.seed, 0, n, device="cuda"), reps)
    p_out, p_ms = timed(lambda: prng.grid_keys_plain(cfg.seed, 0, n, device="cuda"), reps)
    bad = int((k_out != p_out).sum())
    for seed, index in ((2**32 + cfg.seed, 70_000), (cfg.seed, 65_530)):
        bad += int((prng.grid_keys(seed, index, n, device="cuda")
                    != prng.grid_keys_plain(seed, index, n, device="cuda")).sum())
    words = (0xDEADBEEF, 0x12345678)
    bad += int((prng.fold_in_launch(words, 65_530, n, "cuda")
                != prng.fold_in_plain(words, 65_530, n, "cuda")).sum())
    if bad:
        fail(f"K12 keys {name}: {bad} key words differ from the torch threefry's")
    by = 16 * n
    row = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, flops=0, bytes=by, keys=n,
               floor=key_floor(n))
    b_ms, b_by = bound(0, by)
    if row["floor"] is not None and row["floor"]["ms"] > b_ms:
        b_ms, b_by = row["floor"]["ms"], "operations"
    row["bound_ms"], row["bound_by"] = b_ms, b_by
    print(f"[kernel {name}] grid_keys n={n}: {k_ms:.4f} ms, one launch (the torch threefry "
          f"on the card {p_ms:.4f} ms), bound {b_ms:.5f} ms by {b_by}; bit-equal at seed "
          f"{cfg.seed}, at seed {2**32 + cfg.seed} from index 70,000 and under key words "
          f"{words} from index 65,530", flush=True)
    return row


def resim_split(net, cfg, lo, hi, n: int = 64) -> dict:
    """The heuristic retry's ``parity_resim`` per call on the card, split
    by the wall clock over ``n`` AC-S1 stage-0 leftover partitions at the
    retry's shape (one partition, sim_size rows, random changed masks):
    this path's launch (the C entry point: key derived in the kernel, box
    by value, rows copied to pinned host memory on the stream; its device
    time also by CUDA events), its one sync and the two host f64 forwards;
    beside them, measured in the same process, the parts the parent's path
    paid before its launch: the key by ``grid_keys``' torch threefry on the
    card and two host-to-device copies of the box (each followed by a
    sync).  Every split call's parity must equal ``sweep.parity_resim``'s."""
    import numpy as np
    import torch

    from fairify_tpu_torch.models.mlp import predict_np
    from fairify_tpu_torch.utils import prng
    from fairify_tpu_torch.verify import pruning, sweep

    dev, S = net.device, cfg.sim_size
    weights, biases = net.numpy_params()
    rng = np.random.default_rng(0)
    dead = [rng.random(w.shape[1]) > 0.7 for w in weights[:-1]] + [np.zeros(1, bool)]
    words = prng.key_words(cfg.seed)
    stream = torch.cuda.current_stream()
    parts = {k: 0.0 for k in ("launch", "sync", "forwards", "device", "total",
                              "old_keys", "old_copies")}
    for p in range(n + 1):  # the first call warms up
        lo_i = np.asarray(lo[p:p + 1], np.int32)
        hi_i = np.asarray(hi[p:p + 1], np.int32)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn, args, (_rows, host) = pruning._sim_rows_prepare(words, p, lo_i, hi_i, S, dev)
        a.record()
        err = fn(*args, stream.cuda_stream)
        b.record()
        t1 = time.perf_counter()
        stream.synchronize()
        t2 = time.perf_counter()
        sim = host[:S * lo_i.shape[1]].view(S, -1).numpy()
        acc = float((predict_np(weights, biases, sim)
                     == predict_np(weights, biases, sim, dead=dead)).mean())
        t3 = time.perf_counter()
        want = sweep.parity_resim(weights, biases, dead, cfg.seed, p, lo[p], hi[p], S,
                                  device=dev)
        t4 = time.perf_counter()
        sweep.parity_resim(weights, biases, dead, cfg.seed, p, lo[p], hi[p], S, device=dev)
        t5 = time.perf_counter()
        prng.grid_keys_plain(cfg.seed, p, 1, device=dev)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        for arr in (lo[p], hi[p]):
            torch.as_tensor(np.asarray(arr, np.float32), device=dev)
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        if err or acc != want:
            fail(f"parity_resim split, partition {p}: CUDA error {err}, parity {acc} against "
                 f"the wrapper's {want}")
        if p == 0:
            continue
        for k, v in (("launch", t1 - t0), ("sync", t2 - t1), ("forwards", t3 - t2),
                     ("device", a.elapsed_time(b) / 1e3), ("total", t5 - t4),
                     ("old_keys", t6 - t5), ("old_copies", t7 - t6)):
            parts[k] += v / n
    ms = {k: v * 1e3 for k, v in parts.items()}
    print(f"[parity_resim split] {n} AC-S1 partitions at the retry's shape (S = {S}), ms a "
          f"call: parity_resim {ms['total']:.4f} = launch (host, entry point) "
          f"{ms['launch']:.4f} + sync {ms['sync']:.4f} + two host f64 forwards "
          f"{ms['forwards']:.4f}; the launch and its copy on the device (events) "
          f"{ms['device']:.4f}; no key derivation or host-to-device copy left; the parent "
          f"path's key by grid_keys' torch threefry on the card {ms['old_keys']:.4f} and its "
          f"two box copies {ms['old_copies']:.4f}", flush=True)
    return ms


# ---------------------------------------------------------------------------
# Phase 2c: the Phase-S/L/P kernels (K8a, K8b, role logits) against their
# plain versions
# ---------------------------------------------------------------------------

# Of K8a's boxes at most this share may be excused (their final α/β differ
# from the plain version's after a gradient whose f32 sign differs from its
# f64 sign on the plain path).
SIGN_EXCUSE_SHARE = 0.01
# The plain sign frontier K8a's branches come from: a node cap per root, so
# every run bounds the same branches, and a guard on its time.
FRONTIER_NODES = 64
FRONTIER_GUARD_S = 60.0
# Where a failing K8a check writes the boxes it failed on.
FAILURE_DIR = os.path.join("chiprun_out", "chip_smoke")
# Forced launch geometries (warps a block) of K8a and KB's invariance checks.
SIGN_BOUND_FORCES = (2, 8, 16)
KB_FORCES = (4, 8, 16)


def sign_bound_flops(sizes, iters: int) -> int:
    """fp32 flops of one box's K8a call, an FMA counted as 2.  Per layer
    k >= 1 and per form: each evaluation (iters + 1) runs the steps j < k
    (relaxation and constants, ~10 flops per coefficient; the product with
    W_j, 2 * in_j flops per coefficient) and the concretization (8 per
    input and column); each reverse pass (iters) the same product
    transposed, ~12 flops per coefficient, and 4 per input and column.
    Plus IBP, 8 flops per weight."""
    d, outs = sizes[0], list(sizes[1:])
    ins = list(sizes[:-1])
    total = sum(8 * a * b for a, b in zip(ins, outs))
    for k in range(1, len(outs)):
        cols = outs[k]
        step = sum((2 * ins[j] + 10) * outs[j] * cols for j in range(k))
        back = sum((2 * ins[j] + 12) * outs[j] * cols for j in range(k))
        total += 2 * ((iters + 1) * (step + 8 * d * cols) + iters * (back + 4 * d * cols))
    return total


def sign_bound_cost(sizes, B: int, iters: int):
    """(flops, bytes) of one K8a launch over B boxes: :func:`sign_bound_flops`
    per box; the boxes and signs read, the bounds, feasibility, scores and
    resolved signs written, and the packed net read once."""
    d, nh = sizes[0], sum(sizes[1:-1])
    fl = B * sign_bound_flops(sizes, iters)
    by = B * (2 * d * 4 + nh * 4 + 9 + 5 * nh) + 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    return fl, by


def sign_bound_reference(net, lo, hi, signs, alpha_iters: int):
    """K8a's plain version on the card, re-evaluated in float64 along its
    own path.  Returns the plain outputs and α/β, ``excused`` (B,): boxes
    where some gradient component of the path has another sign in f32 than
    in f64 (a kernel that sums in another order may step it the other
    way), the f64 output bounds of the same relaxations (IBP of the last
    layer intersected with the best f64 CROWN iterate), and each hidden
    neuron's bound magnitude (the scale of its score's rounding)."""
    import copy

    import torch

    from fairify_tpu_torch.ops import crown as crown_ops
    from fairify_tpu_torch.ops.interval import affine_interval
    from fairify_tpu_torch.verify import engine

    records = []
    out, ab = engine.sign_bound_plain(net, lo, hi, signs, alpha_iters,
                                      trace=lambda *a: records.append(a))
    net64 = copy.deepcopy(net).double()
    lo64, hi64 = lo.double(), hi.double()
    excused = torch.zeros(lo.shape[0], dtype=torch.bool, device=lo.device)
    best = {}
    last = None
    for k, pre, al, au, bl, bu, grads in records:
        ws_lb, ws_ub, sgn = ([t.double() for t in x] for x in pre)
        n = len(al)
        ps = [t.double().clone().requires_grad_(grads is not None)
              for t in al + au + bl + bu]
        with torch.enable_grad():
            zl, zh = crown_ops.backward_bounds(net64, k, ws_lb, ws_ub, lo64, hi64,
                                               ps[:n], ps[n:2 * n], sgn, ps[2 * n:3 * n],
                                               ps[3 * n:])
            if grads is not None:
                g64 = torch.autograd.grad((zh - zl).sum(), ps, allow_unused=True)
        if grads is not None:
            for g32, g in zip(grads, g64):
                g = torch.zeros_like(g32, dtype=torch.float64) if g is None else g
                both_zero = (g32 == 0) & (g == 0)
                excused |= ((torch.sign(g32.double()) != torch.sign(g)) & ~both_zero).any(-1)
        zl, zh = zl.detach(), zh.detach()
        if k in best:
            best[k] = (torch.maximum(best[k][0], zl), torch.minimum(best[k][1], zh))
        else:
            best[k] = (zl, zh)
        last = (k, ws_lb, ws_ub)
    k, ws_lb, ws_ub = last
    m = net64.masks[k - 1]
    ilo, ihi = affine_interval(net64.weights[k], net64.biases[k],
                               torch.relu(ws_lb[k - 1]) * m, torch.relu(ws_ub[k - 1]) * m)
    f64_lo = torch.maximum(ilo, best[k][0])[..., 0]
    f64_hi = torch.minimum(ihi, best[k][1])[..., 0]
    scale = [torch.maximum(a.abs(), b.abs()).float() for a, b in zip(ws_lb, ws_ub)]
    return out, ab, excused, f64_lo, f64_hi, scale


def sign_bound_verdict(k_out, k_ab, ref):
    """Why K8a's outputs fail against :func:`sign_bound_reference`, or
    None.  The final α/β must equal the plain version's on every box that
    is not excused, and at most SIGN_EXCUSE_SHARE of the boxes may be; on
    every other box the bounds and scores agree to the tolerance of their
    magnitude, ``feasible`` and ``resolved`` are equal, and the bounds
    contain the f64 bounds of the same relaxations up to that same
    tolerance (:func:`sign_bound_band`)."""
    import torch

    (p_lo, p_hi, p_feas, p_scores, p_res), p_ab, excused, f64_lo, f64_hi, scale = ref
    out_lo, out_hi, feas, scores, res = k_out
    B = out_lo.shape[0]
    same = (k_ab == p_ab).all(-1) if p_ab.shape[-1] else torch.ones_like(excused)
    if int((~same & ~excused).sum()):
        return f"final α/β differ on {int((~same & ~excused).sum())} boxes without a " \
               "gradient whose f32 and f64 signs differ"
    if int(excused.sum()) > SIGN_EXCUSE_SHARE * B:
        return f"{int(excused.sum())} of {B} boxes excused, more than {SIGN_EXCUSE_SHARE:g}"
    ok = ~excused
    mag = torch.maximum(p_lo.abs(), p_hi.abs())[ok]
    err = max(tol_ratio(out_lo[ok], p_lo[ok], mag), tol_ratio(out_hi[ok], p_hi[ok], mag))
    err_s = max(tol_ratio(a[ok], b[ok], s[ok]) for a, b, s in zip(scores, p_scores, scale))
    if err > 1.0 or err_s > 1.0:
        return f"bound error {err} / score error {err_s} x tolerance"
    if not torch.equal(feas[ok], p_feas[ok]):
        return f"feasible differs on {int((feas != p_feas)[ok].sum())} boxes"
    n_res = sum(int((a != b)[ok].sum()) for a, b in zip(res, p_res))
    if n_res:
        return f"resolved signs differ on {n_res} neurons"
    bad = int(sign_bound_misses(out_lo, out_hi, p_lo, p_hi, f64_lo, f64_hi)[ok].sum())
    if bad:
        return f"{bad} bounds miss the f64 bounds of their relaxations by more than " \
               "the tolerance"
    return None


def sign_bound_band(p_lo, p_hi):
    """Per box, how far K8a's bounds may lie inside the f64 bounds of their
    relaxations: the tolerance that holds them to the plain version's
    (TOL_REL of the plain bounds' magnitude, plus TOL_ABS).  Both are f32
    sums of the same terms in another order, and where the terms cancel
    each rounds past the f64 bound on either side: on an H100, over the
    AC-S1 twin's node-capped frontiers, the kernel misses by up to 0.22 of
    this band and the plain version by up to 0.62 of the 1e-5 outward
    widening (``probes/k8a_containment.py``)."""
    import torch

    return TOL_REL * torch.maximum(p_lo.abs(), p_hi.abs()).double() + TOL_ABS


def sign_bound_misses(out_lo, out_hi, p_lo, p_hi, f64_lo, f64_hi):
    """(B,) boxes whose bounds miss the f64 ones by more than
    :func:`sign_bound_band`."""
    band = sign_bound_band(p_lo, p_hi)
    return (out_lo.double() - f64_lo > band) | (f64_hi - out_hi.double() > band)


def dump_sign_bound_case(name, alpha_iters: int, lo, hi, pats, k_out, k_ab, ref) -> str:
    """Write the boxes K8a's check fails on (at most 32: α/β that differ
    without an excuse, bounds or scores past tolerance, bounds that miss
    the f64 ones) with their patterns, the kernel's, the plain version's
    and the f64 bounds into a JSON file under FAILURE_DIR; returns its
    path.  ``python probes/k8a_containment.py --replay <file>`` reruns
    such a file."""
    import torch

    (p_lo, p_hi, p_feas, _, _), p_ab, excused, f64_lo, f64_hi, _ = ref
    out_lo, out_hi, feas = k_out[:3]
    same = (k_ab == p_ab).all(-1) if p_ab.shape[-1] else torch.ones_like(excused)
    mag = torch.maximum(p_lo.abs(), p_hi.abs())
    off = lambda a, b: (a - b).abs() > TOL_REL * torch.maximum(b.abs(), mag) + TOL_ABS
    bad = (~same & ~excused) | off(out_lo, p_lo) | off(out_hi, p_hi) | (feas != p_feas) \
        | sign_bound_misses(out_lo, out_hi, p_lo, p_hi, f64_lo, f64_hi)
    idx = torch.nonzero(bad).flatten()[:32].tolist()
    col = lambda t: [float(v) for v in t[idx].double().cpu()]
    case = dict(name=name, alpha_iters=int(alpha_iters), layer_sizes=list(
        map(int, [lo.shape[1]] + [p.shape[1] for p in pats])), rows=idx,
        lo=lo[idx].cpu().tolist(), hi=hi[idx].cpu().tolist(),
        signs=torch.cat([p[idx] for p in pats], dim=1).cpu().tolist(),
        kernel_lo=col(out_lo), kernel_hi=col(out_hi), plain_lo=col(p_lo),
        plain_hi=col(p_hi), f64_lo=col(f64_lo), f64_hi=col(f64_hi),
        feasible=[bool(v) for v in feas[idx].cpu()],
        excused=[bool(v) for v in excused[idx].cpu()])
    os.makedirs(FAILURE_DIR, exist_ok=True)
    path = os.path.join(FAILURE_DIR, "k8a_" + "".join(
        c if c.isalnum() else "_" for c in name) + f"_alpha{alpha_iters}.json")
    with open(path, "w") as f:
        json.dump(case, f)
    return path


def sign_bound_mutants(k_out, ref):
    """Copies of K8a's outputs with one resolved sign flipped and with one
    lower bound raised past its f64 bound."""
    import torch

    out_lo, out_hi, feas, scores, res = k_out
    ok = ~ref[2]
    b = int(torch.nonzero(ok)[0, 0])
    res_m = [r.clone() for r in res]
    res_m[0][b, 0] = 1 if int(res_m[0][b, 0]) != 1 else -1
    yield "a resolved sign flipped", (out_lo, out_hi, feas, scores, res_m)
    lo_m = out_lo.clone()
    f64_lo = ref[3]
    band = sign_bound_band(ref[0][0][b], ref[0][1][b])
    lo_m[b] = float(f64_lo[b] + 2 * band + 1e-3 * (1.0 + f64_lo[b].abs()))
    yield "a lower bound raised past its f64 bound", (lo_m, out_hi, feas, scores, res)


def frontier_rows(net, enc, lo, hi, max_nodes: int = FRONTIER_NODES):
    """Every distinct (box, pattern) one plain ``uniform_sign_bab``
    frontier over the roots ``lo``/``hi`` (int64) bounds: the frontier runs
    with K8a's plain version in place of the kernel (alpha_iters 0, Phase
    L off, so every candidate root branches) and stops each root at
    ``max_nodes`` nodes, so the same roots give the same rows on every
    run (FRONTIER_GUARD_S only guards the time).  Returns (rows (R, 2d +
    hidden) as lo | hi | signs, depths (R,) numpy), or None when the
    frontier never split (no root is a candidate, or every candidate
    certifies at its root)."""
    import torch

    from fairify_tpu_torch.verify import engine
    from fairify_tpu_torch.verify.config import EngineConfig

    recorded = []

    def plain(net_, lo_, hi_, signs, alpha_iters, with_ab=False, live=None):
        recorded.append(torch.cat([lo_, hi_] + list(signs), dim=1))
        return engine.sign_bound_plain(net_, lo_, hi_, signs, alpha_iters)[0]

    kernel, engine.sign_bound = engine.sign_bound, plain
    try:
        engine.uniform_sign_bab(net, enc, lo, hi,
                                EngineConfig(lp_sign=False, alpha_iters=0,
                                             sign_max_nodes=max_nodes),
                                deadline_s=FRONTIER_GUARD_S)
    finally:
        engine.sign_bound = kernel
    if not recorded:
        return None
    rows = torch.unique(torch.cat(recorded), dim=0)
    d = lo.shape[1]
    return rows, (rows[:, 2 * d:] != 0).sum(dim=1).cpu().numpy()


def frontier_split(net, rows, d: int):
    """(lo, hi, per-layer patterns) of :func:`frontier_rows` rows."""
    pats = list(rows[:, 2 * d:].split(list(net.layer_sizes[:-1]), dim=1))
    return rows[:, :d].contiguous(), rows[:, d:2 * d].contiguous(), \
        [p.contiguous() for p in pats]


def frontier_patterns(net, enc, lo, hi, n: int):
    """``n`` distinct (box, pattern)s of :func:`frontier_rows`, taken
    round-robin over the depths (split counts) 1-8, each depth's order
    drawn from ``default_rng(5)``.  Returns (lo, hi, per-layer patterns,
    depth histogram), or None when the frontier never split."""
    import numpy as np
    import torch

    found = frontier_rows(net, enc, lo, hi)
    if found is None:
        return None
    rows, depth = found
    rng = np.random.default_rng(5)
    queues = [list(rng.permutation(np.nonzero(depth == k)[0])) for k in range(1, 9)]
    chosen = []
    while len(chosen) < n and any(queues):
        for q in queues:
            if q and len(chosen) < n:
                chosen.append(q.pop(0))
    if not chosen:
        return None
    sel = rows[torch.as_tensor(chosen, device=rows.device)]
    hist = np.bincount(depth[chosen], minlength=9)[1:].tolist()
    return frontier_split(net, sel, lo.shape[1]) + (hist,)


def check_sign_bound(name, net, lo, hi, pats, alpha_iters: int, reps: int,
                     mutate: bool = False):
    """K8a against :func:`sign_bound_reference` on one launch's boxes
    (:func:`sign_bound_verdict`); with ``mutate`` every copy of
    :func:`sign_bound_mutants` must fail.  Returns the kernel row."""
    from fairify_tpu_torch.verify import engine

    k_res, k_ms = timed(lambda: engine.sign_bound(net, lo, hi, pats, alpha_iters,
                                                  with_ab=True), reps)
    ref = sign_bound_reference(net, lo, hi, pats, alpha_iters)
    _, plain_ms = timed(lambda: engine.sign_bound_plain(net, lo, hi, pats, alpha_iters), 1)
    k_out, k_ab = k_res[:5], k_res[5]
    why = sign_bound_verdict(k_out, k_ab, ref)
    if why:
        path = dump_sign_bound_case(name, alpha_iters, lo, hi, pats, k_out, k_ab, ref)
        fail(f"K8a {name} alpha={alpha_iters}: {why} (the boxes: {path})")
    if mutate:
        for what, mut in sign_bound_mutants(k_out, ref):
            if sign_bound_verdict(mut, k_ab, ref) is None:
                fail(f"K8a {name} alpha={alpha_iters}: a copy with {what} passes the check")
    sizes = [net.in_dim] + list(net.layer_sizes)
    B = lo.shape[0]
    fl, by = sign_bound_cost(sizes, B, alpha_iters)
    row = dict(max_abs_err=float(max((k_out[0] - ref[0][0]).abs().max(),
                                     (k_out[1] - ref[0][1]).abs().max())),
               ms=k_ms, plain_ms=plain_ms, flops=fl, bytes=by)
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    infeas = int((~ref[0][2]).sum())
    print(f"[kernel {name}] sign_bound alpha={alpha_iters} B={B}: {k_ms:.3f} ms (plain "
          f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
          f"{infeas} infeasible branches; excused {int(ref[2].sum())}; α/β, feasible and "
          f"resolved equal, bounds within tolerance of the plain and the f64 bounds"
          f"{'; every mutant fails' if mutate else ''})", flush=True)
    return row


def sign_bound_invariance(name, net, lo, hi, pats, alpha_iters: int) -> dict:
    """K8a under forced launch geometries (warps a block): bounds,
    feasibility, scores, resolved signs and the final α/β must equal the
    default launch's bit for bit.  Returns the default warps and each
    forced geometry's time (ms).  Uses the launch helper's private
    ``_geometry_force``; counted nowhere."""
    import torch

    from fairify_tpu_torch.utils import cuda_build
    from fairify_tpu_torch.verify import engine

    B = lo.shape[0]
    flat = lambda o: list(o[:3]) + list(o[3]) + list(o[4]) + [o[5]]
    base = engine._sign_bound_launch(net, lo, hi, pats, alpha_iters, True, B)
    sizes = tuple([net.in_dim] + list(net.layer_sizes))
    default = engine.sign_bound_geometry(sizes, live=B, sms=cuda_build.sm_count(net.device))
    times = {}
    for w in SIGN_BOUND_FORCES:
        out, ms = timed(lambda: engine._sign_bound_launch(net, lo, hi, pats, alpha_iters, True,
                                                          B, _geometry_force=w), 3)
        if not all(torch.equal(a, b) for a, b in zip(flat(out), flat(base))):
            fail(f"K8a {name} alpha={alpha_iters}: {w} warps a block change its outputs")
        times[w] = ms
    print(f"[geometry {name}] sign_bound alpha={alpha_iters} B={B}: forced warps "
          f"{list(times)} bit-equal to the default {default['warps']} "
          f"({default['per_sm']} blocks an SM); ms by warps {times}", flush=True)
    return dict(default=default["warps"], forced_ms=times)


def kb_invariance(name, net, kb, alpha_iters: int) -> dict:
    """KB under forced launch geometries (warps a block): certificate,
    score and margin must equal the default launch's bit for bit.  Returns
    the default warps and each forced geometry's time (ms).  Uses the
    launch helper's private ``_geometry_force``; counted nowhere."""
    import torch

    from fairify_tpu_torch.verify import engine

    base = engine._kb_launch(net, **kb, alpha_iters=alpha_iters)
    V = kb["valid"].shape[1]
    default = engine.kb_geometry(tuple([net.in_dim] + list(net.layer_sizes)), V)
    times = {}
    for w in KB_FORCES:
        out, ms = timed(lambda: engine._kb_launch(net, **kb, alpha_iters=alpha_iters,
                                                  _geometry_force=w), 3)
        if not all(torch.equal(a, b) for a, b in zip(out, base)):
            fail(f"KB {name} alpha={alpha_iters}: {w} warps a block change its outputs")
        times[w] = ms
    print(f"[geometry {name}] stage0_certify alpha={alpha_iters} N={kb['valid'].shape[0]}: "
          f"forced warps {list(times)} bit-equal to the default {default['warps']} "
          f"({default['per_sm']} blocks an SM); ms by warps {times}", flush=True)
    return dict(default=default["warps"], forced_ms=times)


# C entry-point launches back to back that time_split averages over.
SPLIT_LAUNCHES = 300


def time_split(wrapper, prepared, launches: int = SPLIT_LAUNCHES) -> dict:
    """How one launch's time splits between the device and the wrapper:
    ``wrapper_ms``, the Python wrapper timed as :func:`timed` times it (its
    host work between the two events), and ``entry_ms``, the C entry point
    alone (``prepared``: the launch helper's ``(entry point, arguments but
    the stream, output)``), ``launches`` launches back to back between two
    events, per launch.  The entry-point launches count nowhere."""
    import torch

    fn, args, _out = prepared
    _, w_ms = timed(wrapper, 5)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        err |= fn(*args, stream)
    b.record()
    torch.cuda.synchronize()
    if err:
        fail(f"time split: the entry point returned CUDA error {err}")
    e_ms = a.elapsed_time(b) / launches
    return dict(wrapper_ms=w_ms, entry_ms=e_ms, wrapper_share=max(0.0, 1.0 - e_ms / w_ms))


def fmt_ms(ms) -> str:
    """``ms`` as "x.xxxx ms", or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def graph_ms(fn, launches: int):
    """The device time of ``fn``'s kernels alone, the library chain's
    counterpart of :func:`time_split`'s entry point: ``fn`` captured once in
    a CUDA graph, then ``launches`` replays back to back between two events,
    per replay, so the host's Python between its calls is left out.  ``fn``
    has run before (its libraries are initialized); the allocator's cached
    blocks are released first, since the graph takes a pool of its own.
    None where the capture runs out of device memory."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            fn()
    except torch.cuda.OutOfMemoryError:
        del g
        torch.cuda.empty_cache()
        return None
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(launches):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    torch.cuda.empty_cache()
    return a.elapsed_time(b) / launches


def inter_bounds_cost(sizes, live: int):
    """(flops, bytes) of one K8b launch over ``live`` boxes: each box's
    CROWN bounds (``crown_flops``); its box read and every layer's bounds
    written, and the packed net read once."""
    d, nsum = sizes[0], sum(sizes[1:])
    return live * crown_flops(sizes), live * (2 * d + 2 * nsum) * 4 + 4 * (macs(sizes) + 2 * nsum)


def pad_rows(t, live: int):
    """``t``'s first ``live`` rows, the last of them repeated up to its row
    count (``engine._pad``'s padding, on the card)."""
    import torch

    return torch.cat([t[:live], t[live - 1:live].expand((t.shape[0] - live,) + t.shape[1:])])


# Forced K8b geometries (warps, boxes a block) its bounds must not depend on.
K8B_FORCED = ((16, 1), (8, 2), (4, 4), (1, 1))


def check_inter_bounds(name, net, lo, hi, reps: int, mutate: bool = False, live=None):
    """K8b over the ``live`` first of the rows ``lo``/``hi`` (default all)
    against its plain version (``crown_bounds`` of those rows): every
    layer's bounds to the tolerance of their magnitude; past ``live`` every
    row equal to row ``live - 1`` and the whole launch equal to the full
    launch of all rows bit for bit; bit-equal under the K8B_FORCED
    geometries; with ``mutate`` a copy with one bound moved by
    1e-3 of its magnitude must fail.  Times the wrapper and the C entry
    point alone (:func:`time_split`)."""
    import torch

    from fairify_tpu_torch.ops import crown as crown_ops
    from fairify_tpu_torch.verify import engine

    B = lo.shape[0]
    live = B if live is None else live
    (kl, ku), k_ms = timed(lambda: engine.inter_bounds(net, lo, hi, live=live), reps)
    pb, p_ms = timed(lambda: crown_ops.crown_bounds(net, lo[:live], hi[:live]), reps)
    pl, pu = list(pb.ws_lb), list(pb.ws_ub)

    def err(kl, ku):
        return max(tol_ratio(a[:live], b, torch.maximum(b.abs(), c.abs()))
                   for a, b, c in zip(kl + ku, pl + pu, pu + pl))

    e = err(kl, ku)
    if e > 1.0:
        fail(f"K8b {name} B={B} live={live}: bound error {e} x tolerance")
    if live < B:
        full = engine._inter_bounds_launch(net, lo, hi, B)
        if not all(torch.equal(a[live:], a[live - 1:live].expand_as(a[live:]))
                   for a in kl + ku) or not all(torch.equal(a, b) for a, b in
                                                zip(kl + ku, full[0] + full[1])):
            fail(f"K8b {name}: the launch over {live} of {B} rows differs from the full "
                 "launch, or its padded rows from row live - 1")
    forced = {}
    for f in K8B_FORCED:
        o, forced[str(f)] = timed(lambda: engine._inter_bounds_launch(
            net, lo, hi, live, _geometry_force=f), reps)
        if not all(torch.equal(a, b) for a, b in zip(o[0] + o[1], kl + ku)):
            fail(f"K8b {name}: the bounds under forced geometry {f} (warps, boxes a "
                 "block) differ from the default launch's")
    if mutate:
        km = [t.clone() for t in kl]
        km[-1][0, 0] += 1e-3 * (1.0 + float(pl[-1][0, 0].abs()))
        if err(km, ku) <= 1.0:
            fail(f"K8b {name}: a copy with one bound moved passes the check")
    sizes = [net.in_dim] + list(net.layer_sizes)
    split = time_split(lambda: engine.inter_bounds(net, lo, hi, live=live),
                       engine._inter_bounds_prepare(net, lo, hi, live))
    fl, by = inter_bounds_cost(sizes, live)
    geo = engine.inter_bounds_geometry(sizes, live)
    row = dict(max_abs_err=max(float((a[:live] - b).abs().max())
                               for a, b in zip(kl + ku, pl + pu)),
               ms=k_ms, plain_ms=p_ms, flops=fl, bytes=by, live=live, rows=B,
               time_split=split, geometry=dict(default=[geo["warps"], geo["per"]],
                                               forced_ms=forced))
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel {name}] inter_bounds B={B} live={live}: {k_ms:.4f} ms (C entry point "
          f"alone {split['entry_ms']:.4f} ms, wrapper share {split['wrapper_share']:.2f}; "
          f"plain {p_ms:.4f} ms, bound {row['bound_ms']:.5f} ms by {row['bound_by']}; every "
          f"layer within tolerance; bit-equal under forced (warps, boxes a block) {forced}"
          f"{'; a moved bound fails' if mutate else ''})", flush=True)
    return row


def check_role_logits(name, net, enc, lo, hi, reps: int, mutate: bool = False):
    """The role-logit forward at Phase S's shape (the roots' 32 sampled
    points per assignment, the root axis padded to a power of two) against
    the plain forward: logits to the tolerance of their rounding scale;
    with ``mutate`` a copy with one logit moved must fail.  Row 17's wrapper
    (``attack_logits``, the same kernel) on the same rows is timed beside
    and must be bit-equal; so is the library forward (``library_forward``)."""
    import numpy as np
    import torch

    from fairify_tpu_torch.verify import engine

    xr, pr = engine.build_attack_candidates(enc, np.random.default_rng(3), lo, hi, 32)
    r_pad = 1 << max(xr.shape[0] - 1, 0).bit_length()
    on = lambda a: torch.as_tensor(engine._pad(a, r_pad), device=net.device)
    x, xp = on(xr), on(pr)
    (kx, kp), k_ms = timed(lambda: engine.sample_role_logits(net, x, xp), reps)
    (ax, ap), a_ms = timed(lambda: engine.attack_logits(net, x, xp), reps)
    (px, pp), p_ms = timed(lambda: engine.attack_logits_plain(net, x, xp), reps)
    _, lib_ms = timed(lambda: (library_forward(net, x), library_forward(net, xp)), reps)
    scales = (logit_scale(net, x), logit_scale(net, xp))
    e = logit_error((kx, kp), (px, pp), scales)
    if e > 1.0:
        fail(f"role_logits {name}: logit error {e} x tolerance")
    if not (torch.equal(ax, kx) and torch.equal(ap, kp)):
        fail(f"role_logits {name}: row 17's launch differs from row 21's on its inputs")
    if mutate and logit_error(moved_logit((kx, kp), scales), (px, pp), scales) <= 1.0:
        fail(f"role_logits {name}: a copy with one logit moved passes the check")
    sizes = [net.in_dim] + list(net.layer_sizes)
    rows = 2 * x.numel() // x.shape[-1]
    fl = 2 * rows * macs(sizes)
    by = rows * (x.shape[-1] + 1) * 4 + 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    row = dict(max_abs_err=float(max((kx - px).abs().max(), (kp - pp).abs().max())),
               ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, flops=fl, bytes=by,
               rows=rows, row17_ms=a_ms)
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel {name}] role_logits {tuple(x.shape)} x 2: {k_ms:.4f} ms (row 17's "
          f"wrapper on the same rows {a_ms:.4f} ms, bit-equal; plain {p_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms, bound {row['bound_ms']:.5f} ms by {row['bound_by']}; "
          f"within tolerance{'; a moved logit fails' if mutate else ''})", flush=True)
    return row


def check_phase_s_kernels(name, net, enc, lo, hi, reps: int, mutate: bool = False,
                          frontier: bool = True, geometry: bool = False):
    """K8a (the roots' sign boxes with the root pattern, and branches of
    depth 1-8 from one plain sign frontier over them, at alpha_iters 8 and
    0), K8b (the sign boxes, and one root's 2V role boxes) and the role
    logits on one batch of stage-0 leftovers.  Returns the kernel rows
    (K8a at alpha 8 on the frontier branches, its alpha-0 and root-pattern
    times beside).  Without ``frontier`` (boxes whose candidates all
    certify at the root, where the frontier never splits) K8a runs on the
    root pattern alone.  With ``geometry`` K8a's frontier launch also runs
    under forced geometries (:func:`sign_bound_invariance`)."""
    import numpy as np
    import torch

    from fairify_tpu_torch.verify import engine
    from fairify_tpu_torch.verify.property import role_boxes

    on = lambda a: torch.as_tensor(a, device=net.device)
    slo, shi = (on(a.astype(np.float32)) for a in engine.sign_boxes(enc, lo, hi))
    B = slo.shape[0]
    root = [torch.zeros((B, n), device=net.device) for n in net.layer_sizes[:-1]]
    branches = frontier_patterns(net, enc, lo, hi, B) if frontier else None
    if frontier and branches is None:
        fail(f"{name}: the plain sign frontier never split")
    if branches is not None:
        print(f"[frontier {name}] {branches[0].shape[0]} branches of one plain sign "
              f"frontier, by depth 1-8: {branches[3]}", flush=True)
    rows = {}
    for alpha in (8, 0):
        r_root = check_sign_bound(f"{name} root", net, slo, shi, root, alpha, reps,
                                  mutate=mutate and alpha == 8 and branches is None)
        rows[alpha] = dict(r_root)
        if branches is not None:
            r_deep = check_sign_bound(f"{name} frontier", net, *branches[:3], alpha, reps,
                                      mutate=mutate and alpha == 8)
            rows[alpha] = dict(r_deep, root={k: r_root[k] for k in
                                             ("ms", "plain_ms", "bound_ms", "bound_by")})
            if geometry:
                rows[alpha]["geometry"] = sign_bound_invariance(
                    f"{name} frontier", net, *branches[:3], alpha)
    sign_row = dict(rows[8], alpha0={k: rows[0][k] for k in
                                     ("ms", "plain_ms", "bound_ms", "bound_by", "geometry")
                                     if k in rows[0]})
    inter_row = check_inter_bounds(name, net, slo, shi, reps, mutate=mutate)
    # Phase L's padded blocks: the live-row launch over 1 and 17 rows of a
    # 512-row pad (engine._pad's padding of the first rows).
    inter_row["live_rows"] = {}
    for live in (1, 17):
        r = check_inter_bounds(f"{name} live rows", net, pad_rows(slo[:512], live),
                               pad_rows(shi[:512], live), reps, live=live)
        inter_row["live_rows"][str(live)] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "rows", "time_split")}
    x_lo, x_hi, xp_lo, xp_hi, _ = role_boxes(enc, lo[:1], hi[:1])
    inter4 = check_inter_bounds(
        f"{name} role boxes", net, on(np.concatenate([x_lo[0], xp_lo[0]])),
        on(np.concatenate([x_hi[0], xp_hi[0]])), reps)
    inter_row["role_boxes"] = {k: inter4[k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by", "time_split",
                                                       "geometry")}
    logit_row = check_role_logits(name, net, enc, lo, hi, reps, mutate=mutate)
    return {"sign_bound": sign_row, "inter_bounds": inter_row, "role_logits": logit_row}


# ---------------------------------------------------------------------------
# Phase 2d: the lattice kernels (K9a-c) on real stage-0 leftovers
# ---------------------------------------------------------------------------

LATTICE_PRESETS = ("stress-AC", "relaxed-AC")
CPU_WORKER_THREADS = 7
CARD_ROOT_CAP_S = 2.0
# Roots per preset in card = CPU: the CPU plain path takes seconds per
# AC-S1 stress-AC root (~4e6 points, V = 2) and 18-82 s per relaxed-AC
# root (V = 5) on a shared host, and the timed phases wait for the worker.
CARD_CPU_ROOTS = {"stress-AC": 8, "relaxed-AC": 4}

# Of a chunk's lattice points at most this share may have a certain sign in
# one version and a 0 in the other (each only where the point's |f| lies
# within the two versions' rounding difference of its bound).
LAT_EXCUSE_SHARE = 1e-3


def cpu_copy(net):
    """A CPU copy of ``net`` (``Module.to`` would move the net itself)."""
    from fairify_tpu_torch.models.mlp import from_numpy

    ws, bs = net.numpy_params()
    return from_numpy(ws, bs, [m.cpu().numpy() for m in net.masks], device="cpu")


def small_box(enc, lo, hi, target: int):
    """A sub-box of (lo, hi) with at least ``target`` lattice points where
    the box has them: the PA dims keep their range, the shared dims open
    one after another from their lower ends."""
    import numpy as np

    from fairify_tpu_torch.verify.property import shared_dims

    hi2 = np.array(lo, dtype=np.int64)
    pa = np.asarray(enc.pa_idx)
    hi2[pa] = hi[pa]
    n = 1
    for k in shared_dims(enc, len(lo)):
        w = min(int(hi[k] - lo[k]) + 1, max(1, -(-target // n)))
        hi2[k] = lo[k] + w - 1
        n *= w
    return np.array(lo, dtype=np.int64), hi2


def lattice_eligible(enc, lo, hi, cap: float):
    """Indices of the boxes Phase E0 takes (scan size at most ``cap``),
    with their sizes."""
    from fairify_tpu_torch.ops import lattice as lattice_ops

    sizes = [lattice_ops.enumerable_size(enc, lo[i], hi[i]) for i in range(len(lo))]
    idx = [i for i, n in enumerate(sizes) if n is not None and n <= cap]
    return idx, [sizes[i] for i in idx]


def library_signed_forward(net, x):
    """The lattice forward as a cuBLAS fp32 chain, the library yardstick of
    rows 22-24 (timed here, used nowhere in the port): per layer z = h @ W +
    b, a = |h| @ |W| + |b| and e' = e @ |W| + gamma a (three addmm), then
    ReLU and mask; TF32 off and asserted."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for the lattice library chain")
    h, e = x.reshape(-1, x.shape[-1]), None
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        aw = w.abs()
        gamma = 4.0 * (w.shape[0] + 4) * 2.0 ** -24
        a = torch.addmm(b.abs(), h.abs(), aw)
        e = a.mul_(gamma) if e is None else torch.addmm(a, e, aw, beta=gamma)
        z = torch.addmm(b, h, w)
        if i < net.depth - 1:
            h, e = z.clamp_min_(0.0).mul_(m), e.mul_(m)
        else:
            h = z
    return h, e


def f64_forward(net, x):
    """Float64 logits of f32 inputs ``x`` (..., d) under the net's masks."""
    h = x.double()
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        z = h @ w.double() + b.double()
        h = z if i == net.depth - 1 else z.clamp_min(0.0) * m.double()
    return h.squeeze(-1)


def lattice_verdict(k_scan, k_sfe, p_scan, p_sfe, f64, own_scan):
    """Checks (a)-(d) of one chunk: (failures, excused points).  (a) no
    point has opposite certain signs in the kernel and the plain version;
    (b) every kernel logit lies within its bound of the f64 logit; (c) a
    certain-vs-0 difference only where the plain |f| lies within the two
    versions' f and e differences of its bound, on at most
    LAT_EXCUSE_SHARE of the points; (d) first_flip, margin_count,
    margin_idx and sign_cols equal ``own_scan``, the plain reductions of
    K9b's signs (the scan's own forward), and with nothing excused also
    the plain version's."""
    ks, kf, ke = k_sfe
    ps, pf, pe = p_sfe
    bad = []
    if bool(((ks.int() * ps.int()) == -1).any()):
        bad.append("(a) opposite certain signs")
    if not bool(((kf.double() - f64).abs() <= ke.double()).all()):
        bad.append("(b) a kernel logit outside its bound of the f64 logit")
    diff = ks != ps
    edge = ((pf.abs() - pe).abs() <= (kf - pf).abs() + (ke - pe).abs())
    if bool((diff & ~edge).any()):
        bad.append("(c) a certain-vs-0 difference away from the bound's edge")
    excused = int(diff.any(dim=0).sum())
    if excused > LAT_EXCUSE_SHARE * ks.shape[1]:
        bad.append(f"(c) {excused} excused points")
    names = ("first_flip", "margin_count", "margin_idx", "sign_cols")
    for name, k, o in zip(names, k_scan, own_scan):
        if not torch_equal(k, o):
            bad.append(f"(d) {name} differs from the reductions of K9b's signs")
    if excused == 0:
        for name, k, p in zip(names, k_scan, p_scan):
            if not torch_equal(k, p):
                bad.append(f"(d) {name} differs from the plain version's")
    return bad, excused


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.cpu(), b.cpu()))


def lattice_mutants(k_scan, k_sfe, p_scan, p_sfe, f64, own_scan):
    """Copies of the kernel's outputs with one certain sign flipped, the
    first margin index dropped, the first two margin indices swapped and
    (in a chunk with a flip) the first flip lost: each must fail
    :func:`lattice_verdict`."""
    import torch

    ks, kf, ke = k_sfe
    ff, mc, midx, cols = k_scan
    hit = torch.nonzero(ks != 0)
    if hit.shape[0] == 0 or int(mc) < 2:
        fail("lattice mutants need a chunk with a certain sign and two margin points")
    v, j = int(hit[0, 0]), int(hit[0, 1])
    flipped = ks.clone()
    flipped[v, j] = -flipped[v, j]
    dropped = torch.cat([midx[1:], midx.new_full((1,), -1)])
    swapped = midx.clone()
    swapped[0], swapped[1] = midx[1], midx[0]
    copies = [("a certain sign flipped", k_scan, (flipped, kf, ke)),
              ("a margin index dropped", (ff, mc, dropped, cols), k_sfe),
              ("two margin indices swapped", (ff, mc, swapped, cols), k_sfe)]
    if int(ff) >= 0:
        copies.append(("the first flip lost", (torch.full_like(ff, -1), mc, midx, cols),
                       k_sfe))
    for what, scan, sfe in copies:
        if not lattice_verdict(scan, sfe, p_scan, p_sfe, f64, own_scan)[0]:
            fail(f"lattice check accepts a copy with {what}")


def own_flip(col, vp) -> bool:
    """True iff one point's sign column ``col`` (V,) holds a valid ordered
    pair of opposite certain signs by itself (no dilated partner)."""
    c = col.cpu().numpy().astype(int)
    return bool(((c[:, None] * c[None, :] == -1) & vp).any())


def scan_args(net, enc, lo, hi, c0: int, chunk: int):
    """The box's ScanPlan, as ``decide_box_exhaustive`` lays it out, and
    the arguments of its scan kernel for the chunk at ``c0`` (first
    prefix), on the net's device."""
    import numpy as np
    import torch

    from fairify_tpu_torch.ops import lattice as lattice_ops

    plan = lattice_ops.scan_plan(net, enc, lo, hi, chunk=chunk)
    if isinstance(plan, str):
        return plan, None
    dev = net.device
    valid = np.zeros(enc.n_assign, bool)
    valid[plan.valid] = True
    bases = torch.as_tensor(plan.bases(enc, ()), device=dev)
    return plan, (net, c0, plan.n_suf, *plan.host_desc(), bases,
                  torch.as_tensor(valid, device=dev),
                  torch.as_tensor(plan.vp.astype(np.float32), device=dev), plan.chunk,
                  plan.dims_tuple, int(bases.shape[1]))


def scan_from_signs(plan, args, s):
    """The plain reductions (K9a's, or K9c's for an RA plan) of the sign
    tensor ``s`` of the chunk that ``args`` (:func:`scan_args`) names."""
    from fairify_tpu_torch.ops import lattice as lattice_ops

    _, c0, n_suf, _, _, _, _, valid, vp, _, _, _ = args
    if plan.ra_mode:
        return lattice_ops.scan_ra_from_signs(s, c0, n_suf, valid, vp, plan.ra_ws, plan.eps)
    return lattice_ops.scan_from_signs(s, c0, n_suf, valid, vp)


def check_lattice(name, net, enc, lo, hi, c0: int, reps: int, chunk: int = 1 << 18,
                  mutate: bool = False):
    """K9a (or K9c for an RA query) and K9b on the chunk at ``c0`` of one
    box, as ``decide_box_exhaustive`` lays it out, against their plain
    versions and a float64 forward of the same points.  Returns the row
    of the scan kernel (with the chunk's first flip, margin count and,
    in RA mode, whether the flip was found through a dilated partner
    only) and of K9b."""
    import torch

    from fairify_tpu_torch.ops import lattice as lattice_ops

    plan, args = scan_args(net, enc, lo, hi, c0, chunk)
    if isinstance(plan, str) or len(plan.peel_dims):
        fail(f"{name}: box not scannable in one prefix ({plan})")
    _, _, _, strides, widths, lo_sh, bases, _, _, _, _, d = args
    ra = (plan.ra_ws, plan.eps) if plan.ra_mode else ()
    kname = "lattice_scan_ra" if plan.ra_mode else "lattice_scan"
    kern = getattr(lattice_ops, kname)
    plain = getattr(lattice_ops, kname + "_plain")
    k_scan, k_ms = timed(lambda: kern(*args, *ra), reps)
    p_scan, p_ms = timed(lambda: plain(*args, *ra), 1)
    sargs = (net, c0, strides, widths, lo_sh, bases, plan.chunk, plan.dims_tuple, d)
    k_sfe, s_ms = timed(lambda: lattice_ops.lattice_signs(*sargs, with_fe=True), reps)
    p_sfe, ps_ms = timed(lambda: lattice_ops.device_signs_plain(*sargs, with_fe=True), 1)
    x = lattice_ops.lattice_inputs(c0, strides, widths, lo_sh, bases, plan.chunk,
                                   plan.dims_tuple, d)
    f64 = f64_forward(net, x)
    lib_ms = timed(lambda: library_signed_forward(net, x), reps)[1] if reps > 1 else None
    del x
    if not torch.equal(lattice_ops.lattice_signs(*sargs), k_sfe[0]):
        fail(f"{name}: K9b's signs differ with and without f, e")
    own = scan_from_signs(plan, args, k_sfe[0])
    bad, excused = lattice_verdict(k_scan, k_sfe, p_scan, p_sfe, f64, own)
    if bad:
        fail(f"{name}: lattice chunk at {c0}: {bad}")
    if mutate:
        lattice_mutants(k_scan, k_sfe, p_scan, p_sfe, f64, own)
    V = enc.n_assign
    n_here = min(plan.chunk, plan.n_suf - c0)
    sizes = [net.in_dim] + list(net.layer_sizes)
    # Three products per layer (z, |h||W|, e|W|) of 2 flops per MAC, less
    # layer 0's e|W| (e = 0 at the exact inputs; the kernel skips it).
    flops = (6 * macs(sizes) - 2 * sizes[0] * sizes[1]) * V * n_here
    err = float((k_sfe[1] - p_sfe[1]).abs().max())
    b_ms, b_by = bound(flops, 4 * V * d + 4 * (2 + lattice_ops.MARGIN_BUF)
                       + V * (lattice_ops.MARGIN_BUF + 1))
    bs_ms, bs_by = bound(flops, 4 * V * d + V * n_here)
    ff, mc = int(k_scan[0]), int(k_scan[1])
    dilated = plan.ra_mode and ff >= 0 and not own_flip(k_sfe[0][:, ff], plan.vp)
    print(f"[kernel {name}] {kname} V={V} chunk={plan.chunk} at {c0} (n_total "
          f"{plan.n_suf}{', RA tile ' + str(plan.tile) if plan.ra_mode else ''}): "
          f"{k_ms:.4f} ms (plain {p_ms:.4f} ms, bound {b_ms:.4f} ms); lattice_signs "
          f"{s_ms:.4f} ms (plain {ps_ms:.4f} ms)"
          f"{'' if lib_ms is None else f'; library addmm chain {lib_ms:.4f} ms'}; first_flip {ff}"
          f"{' (through a dilated partner only)' if dilated else ''}, margin_count {mc}, "
          f"excused {excused}, max |f - plain| {err:.3g}"
          f"{', mutants caught' if mutate else ''}", flush=True)
    row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
               chunk=plan.chunk, V=V, excused=excused, first_flip=ff, margin_count=mc,
               dilated=dilated, library_ms=lib_ms)
    srow = dict(ms=s_ms, plain_ms=ps_ms, bound_ms=bs_ms, bound_by=bs_by, max_abs_err=err,
                chunk=plan.chunk, V=V, library_ms=lib_ms)
    return {kname: row, "lattice_signs": srow}


def lattice_invariance(name, net, enc, lo, hi, c0: int) -> list:
    """The signs kernel under forced launch geometries (points a warp tile,
    warps a block) on the chunk at ``c0``: K9b's signs, f and e and the
    scan's (K9a, or K9c in RA mode) first flip, margin count, margin
    indices and sign columns must equal the default launch's bit for bit.
    Returns the forced geometries."""
    import torch

    from fairify_tpu_torch.ops import lattice as lattice_ops

    plan, args = scan_args(net, enc, lo, hi, c0, 1 << 18)
    _, c0, n_suf, strides, widths, lo_sh, bases, valid, vp, chunk, dims_t, d = args
    ra = dict(ra_ws=plan.ra_ws, eps=plan.eps) if plan.ra_mode else {}
    mode = 2 if plan.ra_mode else 1
    ones, zeros = torch.ones_like(valid), torch.zeros_like(vp)

    def run(force):
        sfe = lattice_ops._launch(0, net, c0, 0, strides, widths, lo_sh, bases, ones, zeros,
                                  chunk, dims_t, d, with_fe=True, _geometry_force=force)
        scan = lattice_ops._launch(mode, net, c0, n_suf, strides, widths, lo_sh, bases, valid,
                                   vp, chunk, dims_t, d, _geometry_force=force, **ra)
        return tuple(sfe) + tuple(scan)

    base = run(None)
    forces = [(4, 1), (8, 3), (64, 1)]
    for force in forces:
        if not all(torch_equal(a, b) for a, b in zip(run(force), base)):
            fail(f"{name}: the lattice kernels' outputs change under geometry {force}")
    print(f"[geometry {name}] lattice signs, f, e and the "
          f"{'K9c' if plan.ra_mode else 'K9a'} scan under forced (tw, warps) {forces} "
          f"bit-equal to the default", flush=True)
    return forces


def margin_chunks(net, enc, lo, hi, order):
    """Scan the boxes of ``order`` chunk by chunk (the kernel) for the
    first chunk whose margin count lies in [2, MARGIN_BUF] and the first
    whose count passes MARGIN_BUF while some point is certain for every
    valid assignment.  Returns ({"sparse" | "dense": (box, c0)}, chunks
    scanned, scanned chunks with a flip)."""
    from fairify_tpu_torch.ops import lattice as lattice_ops

    found, n, n_flip = {}, 0, 0
    for i in order:
        plan, args = scan_args(net, enc, lo[i], hi[i], 0, 1 << 18)
        ra = (plan.ra_ws, plan.eps) if plan.ra_mode else ()
        kern = lattice_ops.lattice_scan_ra if plan.ra_mode else lattice_ops.lattice_scan
        for c0 in range(0, plan.n_suf, plan.chunk):
            ff, mc = (int(t) for t in kern(args[0], c0, *args[2:], *ra)[:2])
            n += 1
            n_flip += ff >= 0
            if 2 <= mc <= lattice_ops.MARGIN_BUF:
                found.setdefault("sparse", (i, c0))
            elif lattice_ops.MARGIN_BUF < mc < min(plan.chunk, plan.n_suf - c0):
                found.setdefault("dense", (i, c0))
            if len(found) == 2:
                return found, n, n_flip
    fail(f"no chunk with a sparse and a dense margin in {n} chunks ({found})")


def crossing_twin(net, enc, scale: float, shift: float, device: str):
    """``net`` with the first-layer weights of its protected columns
    multiplied by ``scale`` and ``shift`` taken off its output bias (in
    f32)."""
    import numpy as np

    from fairify_tpu_torch.models.mlp import from_numpy

    ws, bs = net.numpy_params()
    ws = [np.asarray(w, np.float32).copy() for w in ws]
    bs = [np.asarray(b, np.float32).copy() for b in bs]
    for p in np.asarray(enc.pa_idx):
        ws[0][p] = (ws[0][p] * np.float32(scale)).astype(np.float32)
    bs[-1] = (bs[-1] - np.float32(shift)).astype(np.float32)
    return from_numpy(ws, bs, device=device)


# Protected-column weight scales (ascending), boxes (smallest first) and
# candidate shifts per box that the crossing twin's search tries.
CROSS_SCALES, CROSS_BOXES, CROSS_SHIFTS = (1.0, 4.0, 16.0, 64.0, 256.0), 16, 64


def flip_shifts(plan, f, e, n_here: int, k: int = CROSS_SHIFTS):
    """Output-bias shifts ``t``, largest gap first, under which some point
    x is certainly above ``t`` for an assignment a (f - e > t) and a
    partner certainly below it for b (f + e < t), valid_pair[a, b]: the
    partner is x itself (RA-free) or, for a core x, a cell up to eps away
    along the innermost RA axis.  ``f``, ``e``: (V, chunk) plain logits
    and bounds of the chunk."""
    import torch

    lo_, hi_ = (f - e).double(), (f + e).double()
    lo_[:, n_here:] = float("-inf")
    hi_[:, n_here:] = float("inf")
    vp = torch.as_tensor(plan.vp, device=f.device)
    best = []
    V = f.shape[0]
    for a in range(V):
        for b in range(V):
            if not bool(vp[a, b]):
                continue
            if not plan.ra_mode:
                best.append(((lo_[a] - hi_[b]), (lo_[a] + hi_[b]) / 2))
                continue
            w, eps = plan.ra_ws[-1], plan.eps
            la = lo_[a].reshape(-1, w)
            hb = hi_[b].reshape(-1, w)
            core = la[:, eps:w - eps]
            for dl in range(-eps, eps + 1):
                part = hb[:, eps + dl:w - eps + dl]
                best.append(((core - part).flatten(), ((core + part) / 2).flatten()))
    gap = torch.cat([g for g, _ in best])
    mid = torch.cat([m for _, m in best])
    top = torch.topk(gap, min(k, gap.numel()))
    return [float(mid[i]) for g, i in zip(top.values, top.indices) if float(g) > 0]


def crossing_net(net, enc, lo, hi, order):
    """No E0 leftover of the AC-S1 twin holds a certain flip: its SAT
    points sit inside the round-off bound (on stress-AC the bound of the
    stretched inputs exceeds what the protected attribute moves the
    logit) and the host ladder settles them.  The crossing twin (:func:`crossing_twin`) scales
    the protected columns' first-layer weights by the first of
    CROSS_SCALES that lets a pair of certain logits straddle some level
    (:func:`flip_shifts`) on the first chunk of one of the CROSS_BOXES
    smallest boxes of ``order``, and moves its output bias to that level:
    the first shift whose plain scan of the chunk finds a flip and two
    margin points (in RA mode a flip found through a dilated partner
    only).  Returns (box, scale, shift, net)."""
    from fairify_tpu_torch.ops import lattice as lattice_ops

    for scale in CROSS_SCALES:
        knet = crossing_twin(net, enc, scale, 0.0, "cuda")
        for i in order[:CROSS_BOXES]:
            plan, args = scan_args(knet, enc, lo[i], hi[i], 0, 1 << 18)
            _, _, n_suf, strides, widths, lo_sh, bases, _, _, chunk, dims, d = args
            _, f, e = lattice_ops.device_signs_plain(knet, 0, strides, widths, lo_sh, bases,
                                                     chunk, dims, d, with_fe=True)
            for shift in flip_shifts(plan, f, e, min(chunk, n_suf)):
                xnet = crossing_twin(net, enc, scale, shift, "cuda")
                s = lattice_ops.device_signs_plain(xnet, 0, strides, widths, lo_sh, bases,
                                                   chunk, dims, d)
                ff, mc = (int(t) for t in scan_from_signs(plan, (xnet,) + args[1:], s)[:2])
                if ff >= 0 and mc >= 2 and not (plan.ra_mode
                                                and own_flip(s[:, ff], plan.vp)):
                    return i, scale, shift, xnet
    fail(f"no crossing twin with a flip on the first chunk of {CROSS_BOXES} boxes")


def lattice_overflow_case(net, enc, lo, hi):
    """Zero the net's last layer (f = 0 everywhere, every point a margin
    point) on a box of a few thousand points: the scan's margin count
    passes MARGIN_BUF, K9b runs, and the card's decide_box_exhaustive
    verdict equals the CPU's (unsat).  Every point then goes through the
    exact rational forward on the host, so ``net`` is a narrow one.
    Returns K9b's launches."""
    import torch

    from fairify_tpu_torch.models.mlp import from_numpy
    from fairify_tpu_torch.obs import launches
    from fairify_tpu_torch.ops import lattice as lattice_ops

    ws, bs = net.numpy_params()
    ws[-1] = ws[-1] * 0.0
    bs[-1] = bs[-1] * 0.0
    zero = from_numpy(ws, bs, device="cuda")
    plan, args = scan_args(zero, enc, lo, hi, 0, 1 << 18)
    k_scan = lattice_ops.lattice_scan(*args)
    p_scan = lattice_ops.lattice_scan_plain(*args)
    if int(k_scan[1]) <= lattice_ops.MARGIN_BUF or not all(
            torch_equal(a, b) for a, b in zip(k_scan, p_scan)):
        fail(f"overflow case: margin count {int(k_scan[1])}, kernel and plain differ")
    dropped = torch.cat([k_scan[2][1:], k_scan[2].new_full((1,), -1)])
    if torch_equal(dropped, p_scan[2]):
        fail("overflow case: a dropped margin index goes unnoticed")
    n0 = launches.counts()["lattice_signs"]
    card = lattice_ops.decide_box_exhaustive(zero, enc, lo, hi, chunk=1 << 18)
    launched = launches.counts()["lattice_signs"] - n0
    cpu = lattice_ops.decide_box_exhaustive(cpu_copy(zero), enc, lo, hi, chunk=1 << 18)
    if card != ("unsat", None) or cpu != ("unsat", None) or launched < 1:
        fail(f"overflow case: card {card[0]}, CPU {cpu[0]}, K9b launched {launched}")
    print(f"[overflow] {plan.n_suf} points x V={enc.n_assign}, margin count "
          f"{int(k_scan[1])} > {lattice_ops.MARGIN_BUF}: K9b launched {launched}, card "
          f"= CPU = unsat", flush=True)
    return launched


def decide_boxes(net, enc, lo, hi, pipeline_depth: int = 32):
    """decide_box_exhaustive on each box: [(verdict, witness)], seconds."""
    from fairify_tpu_torch.ops import lattice as lattice_ops

    out, t = [], time.perf_counter()
    for i in range(len(lo)):
        v, ce = lattice_ops.decide_box_exhaustive(net, enc, lo[i], hi[i], chunk=1 << 18,
                                                  pipeline_depth=pipeline_depth)
        out.append([v, None if ce is None else [c.tolist() for c in ce]])
    return out, time.perf_counter() - t


def card_roots(net, enc, lo, hi, order, n: int):
    """The first ``n`` boxes of ``order`` that decide_box_exhaustive
    decides on the card within CARD_ROOT_CAP_S.  A box over the cap is
    one whose margin cells the host resolves exactly (in RA mode each
    through decide_leaf on up to (2 eps + 1)^k core points), the same work
    on the CPU path; it is skipped (its first chunks' kernel outputs are
    held against the plain version instead).  An unknown verdict before
    the cap (an evidence mismatch) fails.  Returns (picked indices,
    [(verdict, witness)], card seconds, skipped indices)."""
    from fairify_tpu_torch.ops import lattice as lattice_ops

    picked, out, skipped, t_all = [], [], [], 0.0
    for i in order:
        t = time.perf_counter()
        v, ce = lattice_ops.decide_box_exhaustive(net, enc, lo[i], hi[i], chunk=1 << 18,
                                                  deadline_s=CARD_ROOT_CAP_S)
        dt = time.perf_counter() - t
        if v == "unknown":
            if dt < CARD_ROOT_CAP_S:
                fail(f"box {i}: decide_box_exhaustive unknown after {dt:.3f} s on the card")
            skipped.append(i)
            continue
        t_all += dt
        picked.append(i)
        out.append([v, None if ce is None else [c.tolist() for c in ce]])
        if len(picked) == n:
            break
    if len(picked) < n:
        fail(f"only {len(picked)} E0-eligible leftovers decide within {CARD_ROOT_CAP_S} s")
    return picked, out, t_all, skipped


def lattice_cpu_worker(path_in: str, path_out: str) -> int:
    """``chip_smoke.py --lattice-cpu IN OUT``: the CPU plain path's
    decide_box_exhaustive on the boxes of IN (the AC-S1 twin, per preset,
    and the crossing twin on its box, one chunk in flight: it decides at
    its first chunk), then trained AC-S1's stage 0 over AC partitions
    0-TRAINED_S0_SPAN (:func:`trained_stage0`), into OUT; then phase 12's
    CPU side (:func:`phase12_cpu`, on two threads) into OUT.p12.  Runs in
    its own process beside the rest of phase 1b, phases 2-2c and the ladder
    world, and its phase-12 part beside phases 3-11."""
    import numpy as np
    import torch

    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.verify import presets
    from fairify_tpu_torch.verify.property import encode

    torch.set_num_threads(CPU_WORKER_THREADS)
    net = seeded_net(AC_SIZES, seed=0, device="cpu")
    boxes = np.load(path_in)
    res = {}
    for name in LATTICE_PRESETS:
        enc = encode(presets.get(name).query())
        res[name] = decide_boxes(net, enc, boxes[f"{name}/lo"], boxes[f"{name}/hi"])
        scale, shift = (float(v) for v in boxes[f"{name}/twin"])
        xnet = crossing_twin(net, enc, scale, shift, "cpu")
        res[f"{name}/crossing"] = decide_boxes(xnet, enc, boxes[f"{name}/xlo"][None],
                                               boxes[f"{name}/xhi"][None], pipeline_depth=1)
    t = time.perf_counter()
    res["trained"] = trained_stage0(trained_nets("cpu")["AC-S1"], trained_stage0_cfg(),
                                    TRAINED_S0_SPAN)
    res["trained_s"] = time.perf_counter() - t
    write_json(path_out, res)
    # Phase 12's CPU side after the card = CPU results are out: the card
    # reads them before phase 3 and this at phase 12.  Two threads, beside
    # the card's timed phases.
    torch.set_num_threads(2)
    write_json(path_out + ".p12", phase12_cpu(os.path.join(os.path.dirname(path_out),
                                                           "cpu12")))
    write_json(path_out + ".p13", phase13_cpu(os.path.join(os.path.dirname(path_out), "cpu13"),
                                              path_out + ".card13.npz"))
    return 0


def write_json(path: str, obj) -> None:
    """Write ``obj`` whole or not at all (a reader polls for ``path``)."""
    with open(path + ".tmp", "w") as fp:
        json.dump(obj, fp)
    os.replace(path + ".tmp", path)


def lattice_card_side(net, engine_cfg, work: str) -> dict:
    """Phase 1b, first part.  Per preset, the E0-eligible stage-0
    leftovers of partitions 0-1,024 (smallest first), the card side of
    card = CPU on the CARD_CPU_ROOTS smallest the card decides within
    CARD_ROOT_CAP_S, and the crossing twin (:func:`crossing_net`), whose
    box the card must decide sat through its first flip.  Then starts the
    CPU side in a worker process.  Returns the presets' data with the
    worker, the card results and the worker's output path."""
    import numpy as np

    from fairify_tpu_torch.ops import lattice as lattice_ops
    from fairify_tpu_torch.verify import presets

    lat, boxes, card = {}, {}, {}
    for name in LATTICE_PRESETS:
        cfg = presets.get(name).with_(exact_certify_masks=False, engine=engine_cfg)
        enc, lo, hi = leftovers(net, cfg, None, 1024)
        idx, sizes = lattice_eligible(enc, lo, hi, 6.4e7)
        print(f"[lattice {name}] {len(lo)} stage-0 leftovers of partitions 0-1,024, "
              f"{len(idx)} E0-eligible ({sum(sizes)} scan points, V = {enc.n_assign}, "
              f"eps = {enc.eps})", flush=True)
        order = [idx[k] for k in np.argsort(sizes, kind="stable")]
        pick, got, t_card, skipped = card_roots(net, enc, lo, hi, order,
                                                CARD_CPU_ROOTS[name])
        print(f"[lattice {name}] card = CPU roots: the {len(pick)} smallest the card "
              f"decides within {CARD_ROOT_CAP_S} s ({len(skipped)} smaller ones skipped), "
              f"card {t_card:.3f} s", flush=True)
        o0, scale, shift, xnet = crossing_net(net, enc, lo, hi, order)
        t = time.perf_counter()
        v, ce = lattice_ops.decide_box_exhaustive(xnet, enc, lo[o0], hi[o0], chunk=1 << 18,
                                                  pipeline_depth=1)
        if v != "sat":
            fail(f"{name}: the crossing twin's box decides {v} on the card, not sat "
                 f"through its first flip")
        print(f"[lattice {name}] the crossing twin (protected weights x {scale:g}, output "
              f"bias - {shift:.6g}) decides its box {o0} sat on the card in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        boxes.update({f"{name}/lo": lo[pick], f"{name}/hi": hi[pick], f"{name}/xlo": lo[o0],
                      f"{name}/xhi": hi[o0], f"{name}/twin": np.array([scale, shift])})
        card[name] = (got, t_card, [lattice_ops.enumerable_size(enc, lo[i], hi[i])
                                    for i in pick], len(skipped),
                      [[v, [c.tolist() for c in ce]]])
        lat[name] = dict(enc=enc, lo=lo, hi=hi, idx=idx, sizes=sizes, order=order,
                         skipped=skipped, pick=pick, got=got, o0=o0, xnet=xnet)
    path_in = os.path.join(work, "lattice_boxes.npz")
    path_out = os.path.join(work, "lattice_cpu.json")
    np.savez(path_in, **boxes)
    # Its own process group: the group's kill also stops the SMT workers its
    # phase-12 part spawns.
    worker = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--lattice-cpu",
                               path_in, path_out], cwd=os.path.dirname(os.path.abspath(
                                   __file__)), process_group=0)
    return dict(presets=lat, worker=worker, card=card, out=path_out)


def lattice_kernel_checks(net, lat: dict) -> dict:
    """Phase 1b, second part.  Per preset: the timed K9 rows on the
    largest leftover's first full chunk (stress-AC: and its tail chunk);
    the first two chunks of every small leftover that card = CPU skips;
    the chunk that holds each card = CPU SAT witness; the first chunk
    with a sparse (2-512) and with a dense margin; the
    crossing twin's flip chunk (relaxed-AC: again with K9c's scratch
    dilation forced); the overflow path (stress-AC).  Fails unless the
    chunks held against the plain version include a flip with margin
    points (RA: found through a dilated partner), a sparse and a dense
    margin.  Returns the kernel rows."""
    import numpy as np

    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.ops import lattice as lattice_ops

    rows = {}
    for name in LATTICE_PRESETS:
        p = lat[name]
        enc, lo, hi, order, o0, xnet = (p[k] for k in ("enc", "lo", "hi", "order", "o0",
                                                        "xnet"))
        big = p["idx"][int(np.argmax(p["sizes"]))]
        r = check_lattice(name, net, enc, lo[big], hi[big], 0, reps=5)
        kname = "lattice_scan_ra" if enc.eps and len(enc.ra_idx) else "lattice_scan"
        checked = [r[kname]]
        if name == "stress-AC":
            rows.update(r)  # K9b's row is its V = 2 stress-AC shape
            plan = lattice_ops.scan_plan(net, enc, lo[big], hi[big], chunk=1 << 18)
            c_last = (plan.n_suf - 1) // plan.chunk * plan.chunk
            if plan.n_suf % plan.chunk == 0:
                fail("stress-AC: the largest leftover has no tail chunk")
            checked.append(check_lattice(f"{name} tail", net, enc, lo[big], hi[big],
                                         c_last, reps=3)[kname])
        else:
            rows["lattice_scan_ra"] = r["lattice_scan_ra"]
            rows["lattice_signs"]["relaxed"] = {
                k: r["lattice_signs"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "V", "library_ms")}
        for i in p["skipped"]:
            plan = lattice_ops.scan_plan(net, enc, lo[i], hi[i], chunk=1 << 18)
            for c0 in range(0, min(plan.n_suf, 2 * plan.chunk), plan.chunk):
                checked.append(check_lattice(f"{name} skipped {i}", net, enc, lo[i], hi[i],
                                             c0, reps=1)[kname])
        for i, (v, ce) in zip(p["pick"], p["got"]):
            if v == "sat":  # the chunk that holds a card = CPU SAT witness
                plan = lattice_ops.scan_plan(net, enc, lo[i], hi[i], chunk=1 << 18)
                x = np.asarray(ce[0], np.int64)
                flat = int(sum((x[k] - plan.lo_eff[k]) * st
                               for k, st in zip(plan.suf_dims, plan.suf_strides)))
                checked.append(check_lattice(f"{name} SAT root {i}, witness chunk", net, enc,
                                             lo[i], hi[i], flat - flat % plan.chunk,
                                             reps=1)[kname])
        found, n_scanned, n_flip = margin_chunks(net, enc, lo, hi, order)
        for key in ("sparse", "dense"):
            i, c0 = found[key]
            checked.append(check_lattice(f"{name} {key} margin", net, enc, lo[i], hi[i], c0,
                                         reps=1, mutate=True)[kname])
        fx = check_lattice(f"{name} crossing twin", xnet, enc, lo[o0], hi[o0], 0, reps=3,
                           mutate=True)[kname]
        checked.append(fx)
        rows[kname]["geometry"] = lattice_invariance(f"{name} crossing twin", xnet, enc,
                                                     lo[o0], hi[o0], 0)
        if kname == "lattice_scan_ra":
            # K9c's other dilation path, a global scratch slice per block
            # (RA tiles past LAT_RA_SMEM_MAX), forced on the same chunk.
            keep = lattice_ops.LAT_RA_SMEM_MAX
            lattice_ops.LAT_RA_SMEM_MAX = 0
            try:
                fs = check_lattice(f"{name} crossing twin, scratch dilation", xnet, enc,
                                   lo[o0], hi[o0], 0, reps=3, mutate=True)[kname]
            finally:
                lattice_ops.LAT_RA_SMEM_MAX = keep
            checked.append(fs)
            rows[kname]["scratch"] = {"ms": fs["ms"], "smem_ms": fx["ms"]}
        mcs = [c["margin_count"] for c in checked]
        flips = [c for c in checked if c["first_flip"] >= 0]
        if not any(0 < m <= lattice_ops.MARGIN_BUF for m in mcs) or not any(
                m > lattice_ops.MARGIN_BUF for m in mcs) or not any(
                c["margin_count"] > 0 and (c["dilated"] or kname == "lattice_scan")
                for c in flips):
            fail(f"{name}: the checked chunks lack a flip, a sparse or a dense margin "
                 f"(margin counts {mcs}, flips {len(flips)})")
        print(f"[lattice {name}] {len(checked)} chunks held against the plain version "
              f"({len(p['skipped'])} skipped leftovers x 2, margins found in {n_scanned} "
              f"scanned chunks, {n_flip} of them with a flip): margin counts "
              f"{sorted(mcs)}, {len(flips)} with a flip, none excused beyond "
              f"{max(c['excused'] for c in checked)} points", flush=True)
        if name == "stress-AC":
            olo, ohi = small_box(enc, lo[order[0]], hi[order[0]], 3000)
            rows["lattice_signs"]["overflow_launches"] = lattice_overflow_case(
                seeded_net((AC_SIZES[0], 8, 1), seed=0, device="cuda"), enc, olo, ohi)
        rows[kname]["checked_chunks"] = len(checked)
    return rows


def lattice_card_vs_cpu(worker, card, path_out: str, trained_card: dict) -> dict:
    """Wait for the CPU worker; its verdicts and witnesses must equal the
    card's on every box (the crossing twin's box: sat), and no box may
    stay unknown; trained AC-S1's stage-0 rows must equal the card's
    (:func:`trained_stage0_vs_cpu`), whose summary this returns."""
    t = time.perf_counter()
    while not os.path.exists(path_out):
        if worker.poll() is not None or time.perf_counter() - t > 900:
            fail(f"the CPU lattice worker wrote no results (exit {worker.poll()})")
        time.sleep(0.2)
    print(f"[card = CPU] waited {time.perf_counter() - t:.3f} s for the CPU worker",
          flush=True)
    with open(path_out) as fp:
        cpu = json.load(fp)
    for name, (got, t_card, sizes, skipped, xcard) in card.items():
        want, t_cpu = cpu[name]
        xwant, xt_cpu = cpu[f"{name}/crossing"]
        if got != want or xcard != xwant:
            bad = [(i, g, w) for i, (g, w) in enumerate(zip(got + xcard, want + xwant))
                   if g != w]
            fail(f"card = CPU {name}: {bad}")
        counts = {v: sum(1 for g, _ in got if g == v) for v in ("sat", "unsat")}
        print(f"[card = CPU {name}] the {len(got)} smallest E0-eligible leftovers the "
              f"card decides within {CARD_ROOT_CAP_S} s ({min(sizes)}-{max(sizes)} scan "
              f"points; {skipped} smaller ones over the cap skipped): {counts}, "
              f"witnesses equal, card {t_card:.3f} s, CPU worker {t_cpu:.3f} s; the "
              f"crossing twin's box: sat through a first flip on both, witness equal, "
              f"CPU {xt_cpu:.3f} s", flush=True)
    out = trained_stage0_vs_cpu(trained_card, cpu["trained"])
    out["cpu_s"] = cpu["trained_s"]
    return out


# ---------------------------------------------------------------------------
# Phase 7: stacked families, the chunk loop and the host-frontier BaB
# ---------------------------------------------------------------------------

FAMILY_SEEDS = (0, 1, 2, 3)
# The zoo's same-architecture groups (SURVEY.md §2.4) as seeded twins on
# their own presets: CP-1..11 are 6-32-32-1, DF-1..11 30-16-16-16-1.
ZOO_FAMILIES = (("CP", (6, 32, 32, 1)), ("DF", (30, 16, 16, 16, 1)))
ZOO_MODELS = 11
# Phase 7e's hard budget (15 s before phase 12 joined the run; its checks
# do not depend on it).
FAMILY_SPAN, FAMILY_HARD_S = (0, 4096), 8.0
# The branching score agrees to TOL_REL of the box's largest score + this
# (its coefficients come from backward passes summed in another order).
SCORE_ABS = 1e-6
# Of the host frontier's boxes at most this share may split in another
# order than the plain version's (each only at a near-tie of score·width).
SPLIT_EXCUSE_SHARE = 0.01
CSV_COLS = ("Partition_ID", "Verification", "SAT_count", "UNSAT_count", "UNK_count",
            "h_attempt", "h_success", "B_compression", "S_compression",
            "ST_compression", "H_compression", "T_compression", "C-check",
            "V-accurate", "Pruned-acc", "C1", "C2")


def counted(fn, label: str = "counted"):
    """``(result, launch counts, wall s)`` of ``fn()``, with every launch
    count zeroed just before it runs: one window of WINDOWS (``label``),
    whose K8a and KB launches by shape add up to the counters."""
    import torch

    from fairify_tpu_torch.obs import launches

    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    with ShapeLog() as shapes:
        res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.counts()
    shapes.check_cert(counts, label)
    WINDOWS.append((label, shapes, counts))
    return res, counts, wall


def same_stage0(a, b) -> bool:
    """Equal ``(unsat, sat, witnesses)`` stage-0 results."""
    import numpy as np

    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and set(a[2]) == set(b[2])
            and all(np.array_equal(a[2][k][0], b[2][k][0])
                    and np.array_equal(a[2][k][1], b[2][k][1]) for k in a[2]))


def run_rows(cfg, rep):
    """Ledger rows (id, verdict, witness, engine reason) and the CSV's
    verdict, count, compression, check and witness columns of one run."""
    import csv

    from fairify_tpu_torch.verify import sweep

    with open(sweep.ledger_path(cfg, rep.sink_name)) as fp:
        led = [json.loads(line) for line in fp if line.strip()]
    with open(os.path.join(cfg.result_dir, f"{rep.sink_name}.csv"), newline="") as fp:
        rows = list(csv.reader(fp))
    cols = [rows[0].index(c) for c in CSV_COLS]
    return ([(r["partition_id"], r["verdict"], r["ce"], r.get("engine_reason"))
             for r in led], [[r[i] for i in cols] for r in rows[1:]])


def family_grid(nets, cfg, reps: int):
    """Phase 7a: the family's stage 0 on the whole grid.  One
    ``stage0_families`` run (one KB + one KC launch per segment over
    chunks x models x rows); each model's result and histograms equal its
    solo ``stage0_certify_and_attack``; per segment, the family KB and KC
    equal each model's solo launch bit for bit (the fold the wraparound sum
    of the solo folds); on the first segment both agree with their plain
    versions within the stated tolerances.  Returns ``(rows, family
    results, solo results)``."""
    import numpy as np
    import torch

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.parallel.mesh import stack_models
    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.verify import engine, sweep
    from fairify_tpu_torch.verify.property import encode

    stack = stack_models(nets)
    M = len(nets)
    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    P = len(lo)
    _, segs = grid_mod.segment_spans(P, cfg.grid_chunk, cfg.mega_chunks)
    fam_stats = {}
    fam, launch, wall = counted(lambda: sweep.stage0_families([stack], enc, lo, hi, cfg,
                                                              stats=fam_stats)[0],
                                "family AC grid")
    odd = {k: v for k, v in launch.items()
           if v != (len(segs) if k in ("stage0_certify", "attack_flips") else 0)}
    if odd or len(segs) < 2:
        fail(f"family grid: {len(segs)} segments, launches {launch}")
    solo = []
    for m, net in enumerate(nets):
        st = funnel_mod.StageStats()
        res = sweep.stage0_certify_and_attack(net, enc, lo, hi, cfg, st, {})
        if (not same_stage0(fam[m], res) or not np.array_equal(fam_stats[(0, m)].hist, st.hist)
                or st.boxes != P):
            fail(f"family grid: model {m}'s family stage 0 differs from its solo run")
        solo.append(res)
    sizes = [nets[0].in_dim] + list(nets[0].layer_sizes)
    V = enc.n_assign
    times = {"kb": [], "kc": [], "kb_solo": [], "kc_solo": []}
    plain = {}
    for si in range(len(segs)):
        case = case_inputs(f"family segment {si}", nets[0], cfg, canary=cfg.integrity, seg=si)
        kb, kc = case["kb"], case["kc"]
        kargs = lambda c, mg: (kc["xr"], kc["pr"], kc["valid"], kc["valid_pair"], c, mg,
                               kc["ok"])
        (cert_f, score_f, margin_f), t = timed(lambda: engine.stage0_certify(stack, **kb),
                                               reps)
        times["kb"].append(t)
        out_f, t = timed(lambda: engine.attack_flips(stack, *kargs(cert_f, margin_f)), reps)
        times["kc"].append(t)
        folds, t_kb, t_kc = 0, 0.0, 0.0
        for m, net in enumerate(nets):
            (c, sc, mg), t = timed(lambda: engine.stage0_certify(net, **kb), reps)
            t_kb += t
            o, t = timed(lambda: engine.attack_flips(net, *kargs(c, mg)), reps)
            t_kc += t
            same = (torch.equal(c, cert_f[m]) and torch.equal(sc, score_f[m])
                    and torch.equal(mg, margin_f[m])
                    and all(torch.equal(a, b[m]) for a, b in zip(o[:4], out_f[:4])))
            if not same:
                fail(f"family grid, segment {si}: model {m}'s family KB/KC outputs are "
                     "not bit-equal to its solo launch")
            folds += int(o[4])
        folds = (folds + (1 << 31)) % (1 << 32) - (1 << 31)
        if out_f[4] != folds:
            fail(f"family grid, segment {si}: family fold {out_f[4]}, solo folds {folds}")
        times["kb_solo"].append(t_kb)
        times["kc_solo"].append(t_kc)
        if si:
            continue
        (cert_p, _sp, margin_p), kbp_ms = timed(lambda: engine.each_model(
            stack, lambda n: engine.certify_impl(n, **kb)), 1)
        k_out = engine.attack_flips(stack, *kargs(cert_p, margin_p))
        p_out, kcp_ms = timed(lambda: engine.attack_flips_plain(
            stack, *kargs(cert_p, margin_p)), 1)
        errs = [kb_check(f"family KB model {m}", net, kb, cert_f[m], margin_f[m],
                         cert_p[m], margin_p[m]) for m, net in enumerate(nets)]
        kerrs = [kc_check(f"family KC model {m}", net, kc, [t[m] for t in k_out[:4]],
                          [t[m] for t in p_out[:4]], margin_p[m])
                 for m, net in enumerate(nets)]
        if k_out[4] != engine.fold_int32(cert_p, k_out[0], k_out[1], k_out[3]):
            fail("family KC: the fold is not the kernel's own buffers folded")
        fargs = kargs(cert_f, margin_f)
        lib, lib_dev = kc_library(stack, kc["xr"], kc["pr"], 1)
        split = time_split(lambda: engine.attack_flips(stack, *fargs),
                           engine._attack_flips_prepare(stack, *fargs, case["n_boxes"]),
                           split_launches(times["kc"][0]))
        split["library_device_ms"] = lib_dev
        kc_extra = dict(library_ms=lib, time_split=split,
                        geometry=kc_invariance(f"family segment {si} (M = {M})", stack, fargs))
        plain = dict(kb_ms=kbp_ms, kc_ms=kcp_ms, nb=case["n_boxes"], S=case["S"],
                     kb_err=max(e[0] for e in errs), kc_err=max(e[0] for e in kerrs),
                     near=sum(e[1] for e in errs) + sum(e[1] for e in kerrs))
    rows = {}
    for key, cost in (("stage0_certify", kb_cost(sizes, plain["nb"], V, M)),
                      ("attack_flips", kc_cost(sizes, plain["nb"], plain["S"], V, M))):
        k = "kb" if key == "stage0_certify" else "kc"
        r = dict(ms=times[k][0], solo_sum_ms=times[f"{k}_solo"][0],
                 ms_segments=times[k], solo_sum_ms_segments=times[f"{k}_solo"],
                 plain_ms=plain[f"{k}_ms"], max_abs_err=plain[f"{k}_err"],
                 flops=cost[0], bytes=cost[1], M=M, boxes=plain["nb"],
                 launches=launch[key])
        r["bound_ms"], r["bound_by"] = bound(*cost)
        if key == "attack_flips":
            r.update(kc_extra)
        rows[key] = r
        print(f"[family AC grid] {key} (M = {M}, {plain['nb']} boxes per segment): "
              f"{r['ms']:.3f} ms per segment (segments {[round(t, 3) for t in times[k]]}; "
              f"{M} solo launches {r['solo_sum_ms']:.3f} ms), plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, max_abs_err "
              f"{r['max_abs_err']:.3g}; bit-equal per model to the solo launches", flush=True)
    print(f"[family AC grid] {P} partitions in {len(segs)} segments, M = {M}: stage0_families "
          f"{wall:.3f} s, launches {launch}; per model (unsat, sat) "
          f"{[(int(u.sum()), int(s_.sum())) for u, s_, _ in fam]}, each equal to its solo "
          f"run; discrete outputs differing from the plain version near a threshold "
          f"{plain['near']}", flush=True)
    return rows, fam, solo


def family_chunk(nets, cfg, reps: int) -> dict:
    """Row 7: the family's certificate + attack on one 2,048-row chunk
    (``_family_stage0_kernel``): KB and KC for the M-model family timed
    beside the sum of the solo launches, with the bound; and a wide family,
    11 AC-S1 twins (the zoo's widest groups), whose certify_attack at
    α = 0 and 8 equals every model's solo launch bit for bit, with KB's
    shared memory per block against the card's 227 KB.  Returns the rows."""
    import torch

    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.parallel.mesh import stack_models
    from fairify_tpu_torch.verify import engine

    case = case_inputs("AC chunk", nets[0], cfg.with_(mega_chunks=1), canary=False)
    kb, kc = case["kb"], case["kc"]
    kargs = lambda c, mg: (kc["xr"], kc["pr"], kc["valid"], kc["valid_pair"], c, mg, kc["ok"])
    stack = stack_models(nets)
    (c, _sc, mg), kb_ms = timed(lambda: engine.stage0_certify(stack, **kb), reps)
    _, kc_ms = timed(lambda: engine.attack_flips(stack, *kargs(c, mg)), reps)
    (cp, _sp, mp), kbp_ms = timed(lambda: engine.each_model(
        stack, lambda n: engine.certify_impl(n, **kb)), 1)
    kcp_ms = timed(lambda: engine.attack_flips_plain(stack, *kargs(cp, mp)), 1)[1]
    lib, lib_dev = kc_library(stack, kc["xr"], kc["pr"], reps)
    kc_split = time_split(lambda: engine.attack_flips(stack, *kargs(c, mg)),
                          engine._attack_flips_prepare(stack, *kargs(c, mg), case["n_boxes"]),
                          split_launches(kc_ms))
    kc_split["library_device_ms"] = lib_dev
    kb_solo = kc_solo = 0.0
    for net in nets:
        (c1, _s1, m1), t = timed(lambda: engine.stage0_certify(net, **kb), reps)
        kb_solo += t
        kc_solo += timed(lambda: engine.attack_flips(net, *kargs(c1, m1)), reps)[1]
    sizes = [nets[0].in_dim] + list(nets[0].layer_sizes)
    M, nb, V = len(nets), case["n_boxes"], case["V"]
    rows = {}
    for key, ms, solo, plain, cost in (
            ("stage0_certify", kb_ms, kb_solo, kbp_ms, kb_cost(sizes, nb, V, M)),
            ("attack_flips", kc_ms, kc_solo, kcp_ms, kc_cost(sizes, nb, case["S"], V, M))):
        r = dict(ms=ms, solo_sum_ms=solo, plain_ms=plain, M=M, boxes=nb, flops=cost[0],
                 bytes=cost[1])
        r["bound_ms"], r["bound_by"] = bound(*cost)
        if key == "attack_flips":
            r.update(library_ms=lib, time_split=kc_split)
        rows[key] = r
        print(f"[family chunk] {key} (M = {M}, {nb} boxes): {ms:.3f} ms ({M} solo launches "
              f"{solo:.3f} ms), plain {plain:.3f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}" + ("" if key != "attack_flips" else
                                    f"; C entry point alone {kc_split['entry_ms']:.4f} ms, "
                                    f"library {lib:.4f} ms, device-only {fmt_ms(lib_dev)}"),
              flush=True)
    wide = [seeded_net(AC_SIZES, seed=s, device="cuda") for s in range(ZOO_MODELS)]
    wstack = stack_models(wide)
    for alpha in (0, 8):
        fam = engine.certify_attack(wstack, **kb, xr=kc["xr"], pr=kc["pr"], alpha_iters=alpha)
        for m, net in enumerate(wide):
            solo = engine.certify_attack(net, **kb, xr=kc["xr"], pr=kc["pr"],
                                         alpha_iters=alpha)
            if not all(torch.equal(a[m], b) for a, b in zip(fam, solo)):
                fail(f"wide family (M = {ZOO_MODELS}) alpha={alpha}: model {m}'s outputs "
                     "are not bit-equal to its solo launch")
        smem = engine.kb_geometry(AC_SIZES, V)["smem"]
        if smem > 232448:
            fail(f"KB at alpha={alpha} needs {smem} bytes of shared memory per block")
        print(f"[family chunk] M = {ZOO_MODELS} AC-S1 twins, alpha={alpha}: certify_attack "
              f"bit-equal per model to the solo launches; KB shared memory {smem} of "
              "232,448 bytes per block", flush=True)
    return rows


def zoo_families(work: str, engine_cfg) -> dict:
    """Phase 7b: the zoo's CP and DF groups (11 seeded twins each) on their
    own presets through the family chunk loop (``mega_chunks=0``) and
    ``verify_model(stage0=...)``: every model's ledger and CSV rows and
    funnel equal its solo ``verify_model`` on the default mega path.
    Returns the family runs' launch counts by preset."""
    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.parallel.mesh import stack_models
    from fairify_tpu_torch.verify import presets, sweep
    from fairify_tpu_torch.verify.property import encode

    out = {}
    for name, sizes in ZOO_FAMILIES:
        cfg = presets.get(name).with_(result_dir=os.path.join(work, f"zoo-{name}"),
                                      exact_certify_masks=False, engine=engine_cfg,
                                      soft_timeout_s=10.0, hard_timeout_s=600.0,
                                      mega_chunks=0)
        solo_cfg = cfg.with_(result_dir=os.path.join(work, f"zoo-{name}-solo"),
                             mega_chunks=4)
        nets = [seeded_net(sizes, seed=s, device="cuda") for s in range(ZOO_MODELS)]
        enc = encode(cfg.query())
        _, lo, hi = sweep.build_partitions(cfg)
        stats = {}
        fam, launch, wall = counted(lambda: sweep.stage0_families(
            [stack_models(nets)], enc, lo, hi, cfg, stats=stats)[0], f"zoo family {name}")
        n_chunks = -(-len(lo) // cfg.grid_chunk)
        if launch["stage0_certify"] != n_chunks or launch["attack_flips"] != n_chunks:
            fail(f"{name} family: launches {launch} for {n_chunks} chunks")
        counts = {"sat": 0, "unsat": 0, "unknown": 0}
        t0 = time.perf_counter()
        for m, net in enumerate(nets):
            model = f"{name}-{m + 1}"
            rep = sweep.verify_model(net, cfg, model_name=model, resume=False,
                                     stage0=tuple(fam[m]) + (stats[(0, m)],))
            check_outputs(rep, cfg, net, model, rep.kernel_launches)
            solo = sweep.verify_model(net, solo_cfg, model_name=model, resume=False)
            if (run_rows(cfg, rep) != run_rows(solo_cfg, solo)
                    or rep.funnel["states"] != solo.funnel["states"]
                    or rep.funnel["margin_hist"] != solo.funnel["margin_hist"]):
                fail(f"{name} family: {model}'s ledger, CSV or funnel differs from its "
                     "solo run")
            for k, v in rep.counts.items():
                counts[k] += v
        out[name] = launch
        print(f"[zoo family {name}] {ZOO_MODELS} twins of {'-'.join(map(str, sizes))} on "
              f"{len(lo)} partitions: family stage 0 (chunk loop) {wall:.3f} s, launches "
              f"{launch}; verify_model(stage0=...) and solo runs {time.perf_counter() - t0:.2f}"
              f" s; ledgers, CSVs and funnels equal the solo runs; counts over the family "
              f"{counts}", flush=True)
    return out


def chunk_loop_checks(work: str, gc_net, gc_cfg, ac_net, ac_cfg, reps: int) -> dict:
    """Phase 7c: the chunk loop (``mega_chunks=0``).  GC-1 end to end
    against the mega path (outcomes, ledger, CSV, funnel); the AC grid's
    prune, stage 0 and parity chunk loops (8 launches each) against the mega
    path (2): masks, bounds and parity bit-equal, verdicts, witnesses and
    histograms equal; KA, KB, KC and KD on one 2,048-row AC chunk against
    their plain versions (rows 1, 15 and 10).  Returns the rows and
    launches."""
    import numpy as np

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.verify import pruning, sweep
    from fairify_tpu_torch.verify.property import encode

    req = ("sim_and_bounds", "stage0_certify", "attack_flips", "parity")
    gm = gc_cfg.with_(result_dir=os.path.join(work, "gc-mega"))
    gcl = gc_cfg.with_(result_dir=os.path.join(work, "gc-chunk"), mega_chunks=0)
    rep_m, _launch_m, _ = run_sweep(gc_net, gm, "GC-1", required=req, label="GC-1 mega path")
    rep_c, gc_launch, wall_c = run_sweep(gc_net, gcl, "GC-1", required=req,
                                         label="GC-1 chunk loop")
    gc_sim = WINDOWS[-1][1].sim
    check_outputs(rep_c, gcl, gc_net, "GC-1", gc_launch)
    if (run_rows(gm, rep_m) != run_rows(gcl, rep_c) or rep_m.funnel["states"]
            != rep_c.funnel["states"] or rep_m.funnel["margin_hist"]
            != rep_c.funnel["margin_hist"] or rep_c.counts != {"sat": 2, "unsat": 199,
                                                               "unknown": 0}):
        fail(f"GC-1 chunk loop: {rep_c.counts}; ledger, CSV or funnel differs from the "
             "mega path")
    print(f"[chunk loop GC-1] {rep_c.counts} in {wall_c:.3f} s, launches {gc_launch}; "
          "ledger, CSV and funnel equal the mega path's", flush=True)

    enc = encode(ac_cfg.query())
    _, lo, hi = sweep.build_partitions(ac_cfg)
    chunked = ac_cfg.with_(mega_chunks=0)
    res, launch = {}, {}
    for tag, cfg in (("chunk", chunked), ("mega", ac_cfg)):
        st = funnel_mod.StageStats()

        def passes(cfg=cfg, st=st):
            prune = pruning.sound_prune_grid(ac_net, lo, hi, cfg.sim_size, cfg.seed,
                                             chunk=cfg.grid_chunk, mega_chunks=cfg.mega_chunks)
            s0 = sweep.stage0_certify_and_attack(ac_net, enc, lo, hi, cfg, st, {})
            return prune, s0, sweep.parity_pass(ac_net, prune, lo, hi, cfg), st

        res[tag], launch[tag], _ = counted(passes, f"AC grid passes, {tag}")
    (pc, sc, parc, stc), (pm, sm, parm, stm) = res["chunk"], res["mega"]
    masks_eq = all(np.array_equal(a, b) for k in ("candidates", "st_deads", "pos_prob", "ws_lb",
                                                  "ws_ub")
                   for a, b in zip(getattr(pc, k), getattr(pm, k)))
    n_chunks = -(-len(lo) // ac_cfg.grid_chunk)
    if (not masks_eq or not same_stage0(sc, sm) or not np.array_equal(parc, parm)
            or not np.array_equal(stc.hist, stm.hist)
            or any(launch["chunk"][k] != n_chunks for k in req)):
        fail(f"AC grid chunk loop: masks equal {masks_eq}, stage 0 equal "
             f"{same_stage0(sc, sm)}, parity equal {np.array_equal(parc, parm)}, "
             f"histograms equal {np.array_equal(stc.hist, stm.hist)}; launches "
             f"{launch}")
    print(f"[chunk loop AC grid] {len(lo)} partitions: prune, stage 0 and parity launches "
          f"per pass, chunk loop {[launch['chunk'][k] for k in req]} vs mega path "
          f"{[launch['mega'][k] for k in req]}; masks, bounds, parity, verdicts, witnesses "
          f"and histograms equal", flush=True)
    ac_sim = next(log.sim for label, log, _ in WINDOWS if label == "AC grid passes, chunk")
    sim_shapes = chunk_sim_shapes(ac_net, ac_cfg, gc_sim, ac_sim,
                                  len(sweep.build_partitions(gc_cfg)[1]))
    rows = check_kernels(case_inputs("AC chunk", ac_net, ac_cfg.with_(mega_chunks=1),
                                     canary=False), ac_net, reps, live=True)
    for k, r in rows.items():
        r["launches"] = launch["chunk"][k]
    rows["sim_and_bounds"]["launch_shapes"] = sim_shapes
    return dict(rows=rows, gc_launch=gc_launch, ac_launch=launch["chunk"])


def chunk_sim_shapes(ac_net, ac_cfg, gc_sim, ac_sim, n_gc: int) -> dict:
    """The chunk loops' KA and KD launches by (kind, rows, live rows) from
    their windows' ShapeLog: GC-1's one chunk of its n_gc partitions (a
    chunk never exceeds the grid, so it is not padded), the AC grid's
    chunks over their real rows, the last one (1,664 of 2,048) launched
    over its live rows; fails otherwise.  Times KA and KD on that last
    chunk over its live rows beside a launch over all its 2,048 padded
    rows (what the chunk loop launched before ``live=``)."""
    import numpy as np
    import torch

    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.utils.prng import grid_keys
    from fairify_tpu_torch.verify import pruning, sweep

    _, lo, hi = sweep.build_partitions(ac_cfg)
    P, chunk = len(lo), ac_cfg.grid_chunk
    s0 = (P - 1) // chunk * chunk
    last = P - s0
    want_gc = {(k, n_gc, n_gc): 1 for k in ("ka", "kd")}
    want_ac = {}
    for k in ("ka", "kd"):
        want_ac[(k, chunk, chunk)] = s0 // chunk
        want_ac[(k, chunk, last)] = want_ac.get((k, chunk, last), 0) + 1
    if gc_sim != want_gc or ac_sim != want_ac:
        fail(f"chunk loop launches by (kind, rows, live): GC-1 {gc_sim} (want {want_gc}), AC "
             f"grid {ac_sim} (want {want_ac})")
    dev = ac_net.device
    as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    keys = grid_keys(ac_cfg.seed, s0, chunk, device=dev)
    clo, chi = as_dev(grid_mod.pad_rows(lo[s0:], chunk)), as_dev(grid_mod.pad_rows(hi[s0:], chunk))
    al = torch.ones((chunk, sum(ac_net.layer_sizes[:-1])), dtype=torch.float32, device=dev)
    S = ac_cfg.sim_size
    times = {}
    for kind in ("ka", "kd"):
        kw = dict(alive=al) if kind == "kd" else {}
        _, t_live = timed(lambda: pruning._sim_launch(ac_net, keys, clo, chi, S, last, kind,
                                                      **kw), 3)
        _, t_all = timed(lambda: pruning._sim_launch(ac_net, keys, clo, chi, S, chunk, kind,
                                                     **kw), 3)
        times[kind] = dict(live_ms=t_live, padded_ms=t_all)
    out = dict(gc={f"{k}:{r}:{l}": v for (k, r, l), v in gc_sim.items()},
               ac={f"{k}:{r}:{l}": v for (k, r, l), v in ac_sim.items()}, ac_last_chunk=times)
    print(f"[sim launches by shape, chunk loops] GC-1 {out['gc']}, AC grid {out['ac']} "
          f"(kind:rows:live rows); the AC grid's last chunk over its {last} live rows vs all "
          f"{chunk}, ms {times}", flush=True)
    return out


def kb_live(name, net, kb, alpha: int, full, reps: int, lives=SIM_LIVE) -> dict:
    """KB over ``lives`` live boxes of the batch ``kb`` (the host
    frontier's launches): the live boxes' certificate, score and margin
    equal the full launch's ``full``, the rest box live - 1's
    (``engine.fill_past``); timed through the wrapper."""
    from fairify_tpu_torch.verify import engine

    out = {}
    for live in lives:
        part, ms = timed(lambda: engine.stage0_certify(net, **kb, alpha_iters=alpha,
                                                       live=live), reps)
        if not kc_equal(part, [engine.fill_past(t, live) for t in full]):
            fail(f"KB {name}: the launch over {live} live boxes differs from the full "
                 "launch's first rows or their fill")
        out[str(live)] = dict(ms=ms)
    print(f"[live rows {name}] KB over {list(lives)} live boxes: equal to the full launch's "
          f"rows and fill; ms {out}", flush=True)
    return out


def split_orders(score, lo, hi, bd, n: int = 3):
    """Per box, the host frontier's first ``n`` split dims: the branch dims
    by ``score·width`` descending (stable; widths when every product is 0),
    width-0 dims dropped — ``engine.host_frontier_phase``'s rule.  Also
    returns the products."""
    import numpy as np

    widths = (hi - lo)[:, bd]
    sc = score[:, bd].astype(np.float64) * widths
    sc = np.where(sc.max(axis=1, keepdims=True) > 0, sc, widths.astype(np.float64))
    order = np.argsort(-sc, axis=1, kind="stable")
    return [[int(j) for j in o[:n] if w[j] > 0] for o, w in zip(order, widths)], sc


def frontier_inputs(enc, lo, hi, S: int):
    """KB's and KC's inputs on the card for the boxes ``lo``/``hi`` (F, d)
    int64 as a host-frontier batch: role boxes, encoding tensors and ``S``
    attack candidates per box from ``default_rng(0)``."""
    import numpy as np
    import torch

    from fairify_tpu_torch.verify import engine
    from fairify_tpu_torch.verify.property import role_boxes

    flo, fhi = lo.astype(np.float32), hi.astype(np.float32)
    x_lo, x_hi, xp_lo, xp_hi, valid = role_boxes(enc, flo, fhi)
    xr, pr = engine.build_attack_candidates(enc, np.random.default_rng(0), lo, hi, S)
    on = lambda a: torch.as_tensor(a, device="cuda")
    av, pm, rm = engine.enc_tensors(enc, lo.shape[1])
    kb = dict(x_lo=on(x_lo), x_hi=on(x_hi), xp_lo=on(xp_lo), xp_hi=on(xp_hi), lo=on(flo),
              hi=on(fhi), assign_vals=on(av), pa_mask=on(pm), ra_mask=on(rm),
              eps=float(enc.eps), valid=on(valid), valid_pair=on(enc.valid_pair))
    kc = dict(xr=on(xr), pr=on(pr), valid=kb["valid"],
              ok=torch.zeros(lo.shape[0], dtype=torch.bool, device="cuda"))
    return kb, kc


def host_frontier_checks(work: str, ac_net, enc, lo, hi, reps: int, rows_dev) -> dict:
    """Phase 7d: the host-frontier BaB.  The BaB ladder world at
    ``device_bab=False`` on the card and on the CPU (equal rows), with the
    device-BaB run's verdicts; then KB at α = 8 with the score, and KC, at
    the host frontier's shape (F = 512 AC-S1 stage-0 leftovers, 16 attack
    candidates each) against their plain versions, the split order of
    every box included.  Returns the rows and launches."""
    from fairify_tpu_torch.verify import engine
    from fairify_tpu_torch.verify.property import shared_dims

    rep_d, rows_d, lnet, lcfg = ladder_world(work, "cuda", TAIL, device_bab=False)
    rep_c, rows_c, _, _ = ladder_world(work, "cpu", TAIL, device_bab=False)
    if rows_d != rows_c or [r[1] for r in rows_d] != [r[1] for r in rows_dev]:
        fail(f"ladder world, host frontier: card {rows_d} vs CPU {rows_c} vs device BaB "
             f"{rows_dev}")
    check_outputs(rep_d, lcfg, lnet, "BaB-1", rep_d.kernel_launches)
    print(f"[host frontier ladder] card = CPU = device-BaB verdicts: {rep_d.counts}; "
          f"launches {rep_d.kernel_launches} (stage 0's one KB + one KC among them)", flush=True)

    F, S = min(512, len(lo)), 16
    lo, hi = lo[:F], hi[:F]
    kb, kc = frontier_inputs(enc, lo, hi, S)
    sizes = [ac_net.in_dim] + list(ac_net.layer_sizes)
    V, d = enc.n_assign, lo.shape[1]
    bd = shared_dims(enc, d)
    out = {}
    for alpha in (8, 0):
        (cert_k, score_k, margin_k), k_ms = timed(
            lambda: engine.stage0_certify(ac_net, **kb, alpha_iters=alpha), reps)
        (cert_p, score_p, margin_p), p_ms = timed(
            lambda: engine.certify_impl(ac_net, **kb, alpha_iters=alpha), 1)
        err_m, near = kb_check(f"host-frontier KB alpha={alpha}", ac_net, kb, cert_k,
                               margin_k, cert_p, margin_p, alpha_iters=alpha)
        box_max = score_p.amax(dim=1, keepdim=True)
        tol_s = TOL_REL * box_max + SCORE_ABS
        err_s = float(((score_k - score_p).abs() / tol_s).max())
        if err_s > 1.0:
            fail(f"host-frontier KB alpha={alpha}: score error {err_s} x tolerance")
        # Split order: a box may split in another order only where the first
        # pair of dims the two orders disagree on have score·width products
        # within the score tolerance (times the wider of the two widths).
        ok_k, _ = split_orders(score_k.cpu().numpy(), lo, hi, bd)
        ok_p, sc_p = split_orders(score_p.cpu().numpy(), lo, hi, bd)
        widths = (hi - lo)[:, bd]
        excused = 0
        for i, (a, b) in enumerate(zip(ok_k, ok_p)):
            if a == b:
                continue
            j = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
            tol = None if j is None else (float(tol_s[i, 0])
                                          * max(widths[i, a[j]], widths[i, b[j]]))
            if j is None or abs(sc_p[i, a[j]] - sc_p[i, b[j]]) > tol:
                fail(f"host-frontier KB alpha={alpha}: box {i} splits {a}, the plain "
                     f"version {b}, away from a tie of score·width")
            excused += 1
        if excused > SPLIT_EXCUSE_SHARE * F:
            fail(f"host-frontier KB alpha={alpha}: {excused} of {F} boxes split in "
                 "another order")
        fl, by = kb_cost(sizes, F, V, alpha_iters=alpha)
        r = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err_m, flops=fl, bytes=by,
                 alpha_iters=alpha, boxes=F, score_err_x_tol=err_s,
                 split_order_excused=excused, certified=int(cert_k.sum()),
                 cert_near_diffs=near,
                 geometry=kb_invariance(f"host frontier F={F}", ac_net, kb, alpha),
                 live_rows=kb_live(f"host frontier F={F} alpha={alpha}", ac_net, kb, alpha,
                                   (cert_k, score_k, margin_k), reps))
        r["bound_ms"], r["bound_by"] = bound(fl, by)
        out[f"kb_alpha{alpha}"] = r
        print(f"[host frontier KB alpha={alpha}] F={F} AC-S1 leftovers: {k_ms:.4f} ms "
              f"(plain {p_ms:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}); "
              f"certified {r['certified']}, margin max_abs_err {err_m:.3g}, score error "
              f"{err_s:.3f} x tolerance, split order differs on {excused} boxes (each at "
              f"a near-tie of score·width)", flush=True)
        if alpha == 8:
            args = (kc["xr"], kc["pr"], kc["valid"], kb["valid_pair"], cert_p, margin_p,
                    kc["ok"])
            k_res, kc_ms = timed(lambda: engine.attack_flips(ac_net, *args), reps)
            p_res, kcp_ms = timed(lambda: engine.attack_flips_plain(ac_net, *args), 1)
            err_g, wd = kc_check("host-frontier KC", ac_net, kc, k_res[:4], p_res[:4],
                                 margin_p)
            fl, by = kc_cost(sizes, F, S, V)
            lib, lib_dev = kc_library(ac_net, kc["xr"], kc["pr"], reps)
            split = time_split(lambda: engine.attack_flips(ac_net, *args),
                               engine._attack_flips_prepare(ac_net, *args, F))
            split["library_device_ms"] = lib_dev
            r = dict(ms=kc_ms, plain_ms=kcp_ms, max_abs_err=err_g, flops=fl, bytes=by,
                     boxes=F, S=S, near_diffs=wd, library_ms=lib, time_split=split,
                     geometry=kc_invariance(f"host frontier F={F}", ac_net, args),
                     live_rows=kc_live(f"host frontier F={F}", ac_net, args, reps))
            r["bound_ms"], r["bound_by"] = bound(fl, by)
            r["live_bound_ms"] = {str(n): bound(*kc_cost(sizes, n, S, V))[0] for n in SIM_LIVE}
            out["kc"] = r
            print(f"[host frontier KC] F={F}, S={S}: {kc_ms:.4f} ms (plain {kcp_ms:.4f} "
                  f"ms, library {lib:.4f} ms, bound {r['bound_ms']:.4f} ms by "
                  f"{r['bound_by']}; C entry point alone {split['entry_ms']:.4f} ms, library "
                  f"chain device-only {fmt_ms(lib_dev)})", flush=True)
    out["launches"] = rep_d.kernel_launches
    return out


def family_tail(work: str, nets, ac_cfg, fam, solo) -> dict:
    """Phase 7 end to end: the AC-S1 family's stage-0 results of
    partitions 0-4,096 through ``verify_model(stage0=...)`` per model
    (default engine configuration, 0.02 s soft, 8 s hard): the rows stage
    0 decided equal the model's solo stage-0 verdicts and witnesses; the
    rest are deadline-bound and reported.  Returns the launch counts."""
    import numpy as np

    from fairify_tpu_torch.verify import sweep
    from fairify_tpu_torch.verify.config import EngineConfig

    s, e = FAMILY_SPAN
    cfg = ac_cfg.with_(result_dir=os.path.join(work, "family-tail"), soft_timeout_s=0.02,
                       hard_timeout_s=FAMILY_HARD_S, engine=EngineConfig(max_nodes=1000))
    cut = lambda r: (r[0][s:e], r[1][s:e], {k - s: v for k, v in r[2].items() if s <= k < e})
    totals = {}
    for m, net in enumerate(nets):
        model = f"AC-S1-{m}"
        rep, launch, wall = counted(lambda: sweep.verify_model(
            net, cfg, model_name=model, resume=False, partition_span=FAMILY_SPAN,
            stage0=cut(fam[m])), f"family tail {model}")
        thr = check_outputs(rep, cfg, net, model, launch)
        u, sa, w = cut(solo[m])
        bad = 0
        for o in rep.outcomes:
            p = o.partition_id - 1 - s
            if sa[p]:
                bad += o.verdict != "sat" or any(
                    not np.array_equal(a, b) for a, b in zip(o.counterexample, w[p]))
            elif u[p]:
                bad += o.verdict != "unsat"
        if bad or launch["stage0_certify"] or launch["attack_flips"]:
            fail(f"{model} family run: {bad} stage-0 rows differ from the solo run; "
                 f"launches {launch}")
        for k, v in launch.items():
            totals[k] = totals.get(k, 0) + v
        print(f"[family AC-S1 {model}] partitions {s}-{e}, {FAMILY_HARD_S} s hard: "
              f"{rep.counts}, decided_fraction {thr['decided_fraction']} in {wall:.3f} s "
              f"(stage 0 decided {int(u.sum() + sa.sum())}, equal to the solo run; "
              f"first pass by phase {thr['engine_decided']}); launches {launch}",
              flush=True)
    return totals


# ---------------------------------------------------------------------------
# Phase 8: the IBP path (K10: role_bounds, attack_logits) and the
# exact-certify pass
# ---------------------------------------------------------------------------

K10 = ("role_bounds", "attack_logits")
IBP = dict(use_crown=False)
# Role boxes per check whose bounds are held against float64 references.
K10_SAMPLE = 256
# Largest distance of a row-13/8 bound from its plain version, as a
# multiple of the widening slack.  Sound kernels read 0.023 (IBP) and 0.073
# (CROWN) on the H100; one that skips the output layer's widening reads
# about 1 (its slack taken from its own, narrower interval).
K10_SLACK_LIMIT = 0.25
# AC partitions whose exact masks the CPU re-certifies in Fraction
# arithmetic, the native core's independent twin (~0.1 s each at AC-S1).
EXACT_CPU_PARTS = 48


def f64_role_ibp(net, lo, hi):
    """Unwidened float64 interval bounds (lo, hi) of the output logit for
    role boxes (n, d) of one net: the f32 weights are exact in f64 and the
    sums good to ~1e-12 — what a widened f32 IBP bound must contain."""
    import torch

    l, h = lo.double(), hi.double()
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        w, b = w.double(), b.double()
        wp, wn = torch.clamp(w, min=0.0), torch.clamp(w, max=0.0)
        zl, zh = l @ wp + h @ wn + b, h @ wp + l @ wn + b
        if i == net.depth - 1:
            return zl[..., 0], zh[..., 0]
        l, h = torch.relu(zl) * m.double(), torch.relu(zh) * m.double()


def f64_sampled_range(net, lo, hi, n: int = 32):
    """(min, max) of the float64 logit over ``n`` seeded integer points of
    each role box (n_boxes, d): a range every sound bound contains."""
    import torch

    g = torch.Generator(device=lo.device).manual_seed(0)
    u = torch.rand((lo.shape[0], n, lo.shape[1]), generator=g, device=lo.device,
                   dtype=torch.float64)
    pts = torch.floor(lo.double()[:, None] + u * (hi.double() - lo.double() + 1)[:, None])
    pts = torch.minimum(pts, hi.double()[:, None])
    h = pts
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        z = h @ w.double() + b.double()
        h = z if i == net.depth - 1 else torch.relu(z) * m.double()
    return h[..., 0].amin(dim=1), h[..., 0].amax(dim=1)


def role_bounds_cost(sizes, nrole: int, M: int = 1, use_crown: bool = False):
    """(flops, bytes) of one role_bounds launch over ``nrole`` role boxes
    (both roles counted) and M models: IBP 4 FMAs per weight, CROWN
    ``crown_flops``; the role boxes read once (2d floats each), each
    model's packed net, and two floats written per role box and model."""
    d = sizes[0]
    per = crown_flops(sizes) if use_crown else 8 * macs(sizes)
    pbytes = 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    return M * nrole * per, nrole * 2 * d * 4 + M * (pbytes + nrole * 8)


def attack_logits_cost(sizes, nrows: int, M: int = 1):
    """(flops, bytes) of one attack_logits launch over ``nrows`` candidate
    rows (both roles counted) and M models: each model's forward of each
    row; the rows read once, each model's packed net and one logit per row
    and model written."""
    pbytes = 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    return M * nrows * 2 * macs(sizes), nrows * sizes[0] * 4 + M * (pbytes + nrows * 4)


def library_forward(net, x):
    """The torch forward of rows (..., d) as a chain of cuBLAS products
    (fp32, TF32 off): ``addmm`` per layer, ``baddbmm`` over a stacked
    family's models (the yardstick of rows 17 and 9; the port never calls
    it)."""
    import torch

    h = x.reshape(-1, x.shape[-1])
    stacked = hasattr(net, "n_models")
    if stacked:
        h = h.expand(net.n_models, *h.shape)
    for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        z = torch.baddbmm(b[:, None, :], h, w) if stacked else torch.addmm(b, h, w)
        h = z if i == net.depth - 1 else torch.relu(z) * (m[:, None, :] if stacked else m)
    return h[..., 0]


def fma32(x, y, a):
    """``fmaf(x, y, a)`` elementwise on float32 tensors, exactly: the
    product in float64 (exact), the sum split by TwoSum into its float64
    rounding s and the error e, and s rounded to float32 — moved one step
    toward e where s lies exactly halfway between two float32 values."""
    import torch

    p = x.double() * y.double()
    a64 = a.double()
    s = p + a64
    bb = s - p
    e = (p - (s - bb)) + (a64 - bb)
    r = s.float()
    other = torch.nextafter(r, torch.where(s > r.double(), torch.inf, -torch.inf).float())
    tie = (s != r.double()) & (s == (r.double() + other.double()) / 2) & (e != 0)
    up = torch.maximum(r, other)
    down = torch.minimum(r, other)
    return torch.where(tie, torch.where(e > 0, up, down), r)


def ibp_ordered(net, lo, hi):
    """Row 13's IBP output bounds (lb, ub) of role boxes (n, d) of one net
    in the kernel's own order: per unit the four sums as index-ordered
    ``fmaf`` chains from 0 (:func:`fma32`), ``(a1 + a2) + b``, the slack
    ``fmaf(SLACK_REL, max(|lo|, |hi|), SLACK_ABS)``, ReLU and the mask — so
    the kernel must equal it bit for bit."""
    import torch

    from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL

    rel = torch.tensor(SOUND_SLACK_REL, dtype=torch.float32, device=lo.device)
    eps = torch.tensor(SOUND_SLACK_ABS, dtype=torch.float32, device=lo.device)
    l, h = lo.float(), hi.float()
    for k, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
        wp, wn = torch.clamp(w, min=0.0), torch.clamp(w, max=0.0)
        a1 = a2 = a3 = a4 = torch.zeros((l.shape[0], w.shape[1]), device=lo.device)
        for i in range(w.shape[0]):
            li, hi_ = l[:, i:i + 1], h[:, i:i + 1]
            a1 = fma32(li, wp[i], a1)
            a2 = fma32(hi_, wn[i], a2)
            a3 = fma32(hi_, wp[i], a3)
            a4 = fma32(li, wn[i], a4)
        zl, zh = (a1 + a2) + b, (a3 + a4) + b
        slack = fma32(rel, torch.maximum(zl.abs(), zh.abs()), eps)
        zl, zh = zl - slack, zh + slack
        if k == net.depth - 1:
            return zl[:, 0], zh[:, 0]
        l, h = torch.clamp(zl, min=0.0) * m, torch.clamp(zh, min=0.0) * m


def library_interval(net, boxes):
    """Row 13's IBP as a chain of cuBLAS products (fp32, TF32 off): the
    centre-radius interval image, per layer ``c W + b`` (``addmm``;
    ``baddbmm`` over a stacked family's models) and ``r |W|``, then the
    widening, ReLU and the mask — the library yardstick of rows 13 and 8,
    which the port never calls."""
    import torch

    from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL

    stacked = hasattr(net, "n_models")
    out = []
    for lo, hi in ((boxes[0], boxes[1]), (boxes[2], boxes[3])):
        lo, hi = lo.reshape(-1, lo.shape[-1]), hi.reshape(-1, hi.shape[-1])
        c, r = (lo + hi) * 0.5, (hi - lo) * 0.5
        if stacked:
            c, r = c.expand(net.n_models, *c.shape), r.expand(net.n_models, *r.shape)
        for i, (w, b, m) in enumerate(zip(net.weights, net.biases, net.masks)):
            if stacked:
                zc = torch.baddbmm(b[:, None, :], c, w)
                zr = torch.bmm(r, w.abs())
            else:
                zc, zr = torch.addmm(b, c, w), r @ w.abs()
            zl, zh = zc - zr, zc + zr
            s = SOUND_SLACK_REL * torch.maximum(zl.abs(), zh.abs()) + SOUND_SLACK_ABS
            zl, zh = zl - s, zh + s
            if i == net.depth - 1:
                out += [zl[..., 0], zh[..., 0]]
                break
            mm = m[:, None, :] if stacked else m
            zl, zh = torch.relu(zl) * mm, torch.relu(zh) * mm
            c, r = (zl + zh) * 0.5, (zh - zl) * 0.5
    return out


def k10_refs(net, boxes, use_crown: bool):
    """Per role, the float64 range over the first K10_SAMPLE role boxes that
    the kernel's bounds must contain: the interval bounds (IBP) or the
    sampled logits' range (CROWN, tighter than IBP)."""
    ref = []
    for role in (0, 1):
        lo = boxes[2 * role].reshape(-1, boxes[0].shape[-1])[:K10_SAMPLE]
        hi = boxes[2 * role + 1].reshape(-1, boxes[0].shape[-1])[:K10_SAMPLE]
        ref.append(f64_sampled_range(net, lo, hi) if use_crown else f64_role_ibp(net, lo, hi))
    return ref


def role_bounds_verdict(k, p, ref):
    """Row 13's outputs ``k`` against the plain version's ``p`` (both
    ``(lb_x, ub_x, lb_p, ub_p)`` of one net): ``(error as a multiple of
    TOL_REL of the role's interval magnitude max(|lb|, |ub|) + TOL_ABS,
    error as a multiple of the widening slack, bounds that fail to contain
    ``ref``)``."""
    import torch

    from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL

    err = slack = 0.0
    bad = 0
    for role in (0, 1):
        mag = torch.maximum(p[2 * role].abs(), p[2 * role + 1].abs())
        for i in (2 * role, 2 * role + 1):
            err = max(err, tol_ratio(k[i], p[i], mag))
            slack = max(slack, float(((k[i] - p[i]).abs()
                                      / (SOUND_SLACK_REL * mag + SOUND_SLACK_ABS)).max()))
        lo = k[2 * role].reshape(-1)[:K10_SAMPLE].double()
        hi = k[2 * role + 1].reshape(-1)[:K10_SAMPLE].double()
        bad += int((lo > ref[role][0]).sum() + (hi < ref[role][1]).sum())
    return err, slack, bad


def role_bounds_fails(err, slack, bad) -> bool:
    """Whether :func:`role_bounds_verdict`'s reading fails the check."""
    return err > 1.0 or slack > K10_SLACK_LIMIT or bad > 0


def role_bounds_mutants(k, ref):
    """Copies of row 13's outputs ``(lb_x, ub_x, lb_p, ub_p)`` that a sound
    check must fail: one lower bound moved past its float64 bound, and
    every bound moved inward by one widening slack (the output layer's
    widening removed)."""
    import torch

    from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL

    moved = [t.clone() for t in k]
    moved[0].view(-1)[0] = float(ref[0][0][0]) + 1e-3 * (1.0 + abs(float(ref[0][0][0])))
    unwidened = []
    for role in (0, 1):
        lo, hi = k[2 * role], k[2 * role + 1]
        s = SOUND_SLACK_REL * torch.maximum(lo.abs(), hi.abs()) + SOUND_SLACK_ABS
        unwidened += [lo + s, hi - s]
    return {"a bound moved past its float64 bound": moved,
            "the output widening removed": unwidened}


# Forced row-13 geometries the bounds must not depend on: IBP (role boxes a
# warp tile, warps a block), CROWN (warps a block).
RB_FORCED = {False: ((4, 1), (16, 3), (8, 12)), True: (1, 4, 16)}


def role_bounds_invariance(name, net, boxes, use_crown: bool, live: int, k) -> dict:
    """Row 13's (or 8's) launch over ``live`` boxes under every RB_FORCED
    geometry must give the bounds ``k`` of its default launch bit for bit.
    Returns each forced geometry's time (ms, the launch helper)."""
    import torch

    from fairify_tpu_torch.verify import engine

    B, V = boxes[0].shape[0], boxes[0].shape[1]
    times = {}
    for f in RB_FORCED[bool(use_crown)]:
        run = lambda: engine._role_bounds_launch(net, boxes, B, V, live, use_crown,
                                                 _geometry_force=f)
        o, times[str(f)] = timed(run, 3)
        got = o.view((getattr(net, "n_models", 1), 4, B * V))
        want = torch.stack([t.reshape(got.shape[0], B * V) for t in k], dim=1)
        if not torch.equal(got, want):
            fail(f"role_bounds {name}: the bounds under forced geometry {f} differ from "
                 "the default launch's")
    return times


def check_role_bounds(name, net, boxes, use_crown: bool, reps: int, mutate: bool = False,
                      live=None, ordered: bool = False):
    """Row 13 (one net) against its plain version on role boxes
    ``(x_lo, x_hi, xp_lo, xp_hi)`` (B, V, d), the launch over the ``live``
    first boxes (default all; past it the boxes repeat box ``live - 1``):
    every bound to TOL_REL of its interval magnitude and within
    K10_SLACK_LIMIT of the widening slack (``SOUND_SLACK_REL`` of that
    magnitude + ``SOUND_SLACK_ABS``), the first K10_SAMPLE role boxes'
    bounds containing their float64 reference; past ``live`` every box
    equal to box ``live - 1`` and the launch equal to the full launch bit
    for bit; bit-equal under the RB_FORCED geometries; with ``ordered``
    (IBP) bit-equal to the plain-order reference :func:`ibp_ordered`; with
    ``mutate`` every copy of :func:`role_bounds_mutants` must fail.  Times
    the wrapper and the C entry point alone (:func:`time_split`) and, in
    IBP mode, the library chain (:func:`library_interval`).  Returns the
    row."""
    import torch

    from fairify_tpu_torch.verify import engine

    B, V, d = boxes[0].shape
    live = B if live is None else live
    k, k_ms = timed(lambda: engine.role_logit_bounds(net, *boxes, use_crown, live=live), reps)
    p, p_ms = timed(lambda: engine.role_logit_bounds_plain(net, *boxes, use_crown), 1)
    ref = k10_refs(net, boxes, use_crown)
    err, slack, bad = role_bounds_verdict(k, p, ref)
    if role_bounds_fails(err, slack, bad):
        fail(f"role_bounds {name}: bound error {err} x tolerance = {slack} x the widening "
             f"slack, {bad} bounds do not contain their float64 reference")
    if live < B:
        full = engine.role_logit_bounds(net, *boxes, use_crown)
        if not all(torch.equal(a, b) for a, b in zip(k, full)) or not all(
                torch.equal(a[live:], a[live - 1:live].expand_as(a[live:])) for a in k):
            fail(f"role_bounds {name}: the launch over {live} of {B} boxes differs from the "
                 "full launch, or its padded boxes from box live - 1")
    forced = role_bounds_invariance(name, net, boxes, use_crown, live, k)
    if ordered:
        o = [ibp_ordered(net, boxes[2 * r].reshape(-1, d), boxes[2 * r + 1].reshape(-1, d))
             for r in (0, 1)]
        ndiff = sum(int((a.reshape(-1) != b).sum())
                    for a, b in zip(k, (o[0][0], o[0][1], o[1][0], o[1][1])))
        if ndiff:
            fail(f"role_bounds {name}: {ndiff} bounds differ from the plain-order reference")
    if mutate:
        for what, km in role_bounds_mutants(k, ref).items():
            if not role_bounds_fails(*role_bounds_verdict(km, p, ref)):
                fail(f"role_bounds {name}: a copy with {what} passes")
    lib_ms = None
    if not use_crown:
        _, lib_ms = timed(lambda: library_interval(net, boxes), reps)
    split = time_split(lambda: engine.role_logit_bounds(net, *boxes, use_crown, live=live),
                       engine._role_bounds_prepare(net, boxes, B, V, live, use_crown))
    sizes = [net.in_dim] + list(net.layer_sizes)
    nrole = 2 * B * V
    fl, by = role_bounds_cost(sizes, 2 * live * V, use_crown=use_crown)
    geo = engine.role_bounds_geometry(sizes, V, 2 * live * V, 1, use_crown)
    row = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, max_abs_err=max(
        float((a - b).abs().max()) for a, b in zip(k, p)),
               err_x_tol=err, err_x_slack=slack, role_boxes=nrole, live=live, flops=fl,
               bytes=by, mode="crown" if use_crown else "ibp", time_split=split,
               geometry=dict(default=[geo["tw"], geo["warps"], geo["grid"]],
                             forced_ms=forced), ordered_bit_equal=ordered or None)
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel {name}] role_bounds {row['mode']} {nrole} role boxes, live boxes {live} "
          f"of {B}: {k_ms:.4f} ms (C entry point alone {split['entry_ms']:.4f} ms, wrapper "
          f"share {split['wrapper_share']:.2f}; plain {p_ms:.4f} ms"
          f"{'' if lib_ms is None else f', library {lib_ms:.4f} ms'}, bound "
          f"{row['bound_ms']:.5f} ms by {row['bound_by']}; error {err:.3f} x tolerance = "
          f"{slack:.3f} x the widening slack; {K10_SAMPLE} x 2 role boxes contain their "
          f"float64 {'sampled range' if use_crown else 'interval bounds'}; bit-equal under "
          f"forced geometries {forced}"
          f"{'; bit-equal to the plain-order reference' if ordered else ''}"
          f"{'; a bound moved past it and the unwidened copy fail' if mutate else ''})",
          flush=True)
    return row


def logit_error(k, p, scales) -> float:
    """Largest error of the logits ``k`` (one tensor per role) against the
    plain version's ``p``, as a multiple of TOL_REL of each logit's rounding
    scale ``scales`` (:func:`logit_scale`) + TOL_ABS (<= 1 passes)."""
    return max(tol_ratio(a, b, s) for a, b, s in zip(k, p, scales))


def moved_logit(k, scales):
    """A copy of the logits ``k`` (one tensor per role) with the first
    logit moved by 1e-3 of its rounding scale + 1e-3: the checks of rows
    17 and 21 must fail it."""
    km = [t.clone() for t in k]
    km[0].view(-1)[0] += 1e-3 * (1.0 + float(scales[0].view(-1)[0]))
    return km


def check_attack_logits(name, net, xr, pr, reps: int, mutate: bool = False):
    """Row 17 (one net) against its plain version: every logit to TOL_REL of
    its rounding scale |h| @ |W| + |b| (``logit_scale``) + TOL_ABS; with
    ``mutate`` a copy with one logit moved must fail.  Also times the
    library forward (``library_forward``).  Returns the row."""
    from fairify_tpu_torch.verify import engine

    (kx, kp), k_ms = timed(lambda: engine.attack_logits(net, xr, pr), reps)
    (px, pp), p_ms = timed(lambda: engine.attack_logits_plain(net, xr, pr), 1)
    _, lib_ms = timed(lambda: (library_forward(net, xr), library_forward(net, pr)), reps)
    scales = (logit_scale(net, xr), logit_scale(net, pr))
    e = logit_error((kx, kp), (px, pp), scales)
    if e > 1.0:
        fail(f"attack_logits {name}: logit error {e} x tolerance")
    if mutate and logit_error(moved_logit((kx, kp), scales), (px, pp), scales) <= 1.0:
        fail(f"attack_logits {name}: a copy with one logit moved passes the check")
    sizes = [net.in_dim] + list(net.layer_sizes)
    nrows = 2 * xr.numel() // xr.shape[-1]
    fl, by = attack_logits_cost(sizes, nrows)
    row = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, err_x_tol=e, rows=nrows,
               max_abs_err=float(max((kx - px).abs().max(), (kp - pp).abs().max())),
               flops=fl, bytes=by)
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel {name}] attack_logits {nrows} rows: {k_ms:.4f} ms (plain "
          f"{p_ms:.4f} ms, library {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']}; error {e:.3f} x tolerance"
          f"{'; a moved logit fails' if mutate else ''})", flush=True)
    return row


def attack_logits_invariance(name, net, xr, pr) -> dict:
    """Row 17's logits at the smallest rows per block (one warp of 4-row
    tiles) and at the largest (the widest warp tile, every warp shared
    memory holds) must be bit-equal: a row's sums do not depend on the tile,
    the warp or the block that carries it.  Uses the launch helper's
    private ``_geometry_force``; counted nowhere."""
    import torch

    from fairify_tpu_torch.verify import engine

    sizes = [net.in_dim] + list(net.layer_sizes)
    big = engine.attack_logits_geometry(sizes, 1 << 30)
    geos = {"smallest": (4, 1), "largest": (big["tw"], big["warps"])}
    outs = {k: engine._launch_attack_logits(net, xr, pr, None, _geometry_force=g)
            for k, g in geos.items()}
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs["smallest"], outs["largest"])):
        fail(f"attack_logits {name}: the logits at {geos['smallest']} and "
             f"{geos['largest']} (rows per warp tile, warps) differ")
    print(f"[geometry {name}] attack_logits at (tw, warps) {geos['smallest']} and "
          f"{geos['largest']}: bit-equal", flush=True)
    return {k: list(g) for k, g in geos.items()}


def k10_inputs(enc, lo, hi, S: int, seed: int = 0):
    """Role boxes and attack candidates of boxes (n, d) on the card."""
    import numpy as np
    import torch

    from fairify_tpu_torch.verify import engine
    from fairify_tpu_torch.verify.property import role_boxes

    on = lambda a: torch.as_tensor(a, device="cuda")
    boxes = role_boxes(enc, lo.astype(np.float32), hi.astype(np.float32))[:4]
    xr, pr = engine.build_attack_candidates(enc, np.random.default_rng(seed), lo, hi, S)
    return [on(b) for b in boxes], on(xr), on(pr)


def k10_kernel_checks(ac_net, ac_cfg, enc, lo, hi, reps: int) -> dict:
    """Phase 8b's kernel checks: rows 13 (IBP and CROWN) and 17 at one
    2,048-row AC chunk (the chunk loop's shape: 2,048 x V role boxes per
    role, 128 candidates) and at the host frontier's (F = 512 AC-S1
    stage-0 leftovers ``lo``/``hi``, 16 candidates).  Returns the rows."""
    case = case_inputs("AC chunk", ac_net, ac_cfg.with_(mega_chunks=1), canary=False)
    kb, kc = case["kb"], case["kc"]
    boxes = [kb["x_lo"], kb["x_hi"], kb["xp_lo"], kb["xp_hi"]]
    rows = {"role_bounds": check_role_bounds("AC chunk", ac_net, boxes, False, reps,
                                             mutate=True, ordered=True),
            "attack_logits": check_attack_logits("AC chunk", ac_net, kc["xr"], kc["pr"],
                                                 reps, mutate=True)}
    rows["role_bounds"]["crown"] = check_role_bounds("AC chunk", ac_net, boxes, True,
                                                     reps, mutate=True)
    fb, fxr, fpr = k10_inputs(enc, lo[:512], hi[:512], 16)
    rows["role_bounds"]["host_frontier"] = check_role_bounds("host frontier", ac_net, fb,
                                                             False, reps, ordered=True)
    # The host frontier's padded batches: the launch over 17 and 1 live
    # boxes of the F = 512 pad.
    rows["role_bounds"]["host_frontier"]["live_boxes"] = {
        str(live): {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "time_split")}
        for live in (17, 1)
        for r in [check_role_bounds("host frontier live boxes", ac_net,
                                    [pad_rows(b, live) for b in fb], False, reps, live=live,
                                    ordered=True)]}
    rows["attack_logits"]["host_frontier"] = check_attack_logits("host frontier", ac_net,
                                                                 fxr, fpr, reps)
    rows["attack_logits"]["geometry"] = attack_logits_invariance("AC chunk", ac_net,
                                                                 kc["xr"], kc["pr"])
    return rows


def k10_family(nets, ac_cfg, reps: int) -> dict:
    """Phase 8c: a family of four AC-S1 twins through ``stage0_families`` on
    the IBP path over the whole AC grid (the chunk loop: one row-8 and one
    row-9 launch per chunk), each model's verdicts and witnesses equal to its
    solo stage 0; on one 2,048-row chunk the family launches of rows 8 and 9
    bit-equal per model to that model's solo launch of rows 13 and 17 and
    within tolerance of the plain versions, timed beside the solo sum and
    the library forward.  Returns the rows."""
    from dataclasses import replace

    import torch

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.parallel.mesh import stack_models
    from fairify_tpu_torch.verify import engine, sweep
    from fairify_tpu_torch.verify.property import encode

    cfg = ac_cfg.with_(engine=replace(ac_cfg.engine, **IBP))
    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    stack = stack_models(nets)
    fam, launch, wall = counted(lambda: sweep.stage0_families([stack], enc, lo, hi, cfg))
    n_chunks = -(-len(lo) // cfg.grid_chunk)
    if any(launch[k] != n_chunks for k in K10):
        fail(f"IBP family stage 0: launches {launch}, expected {n_chunks} of each K10 row")
    solo_wall = 0.0
    for m, net in enumerate(nets):
        solo, _, w = counted(lambda: sweep.stage0_certify_and_attack(
            net, enc, lo, hi, cfg, funnel_mod.StageStats(), {}))
        solo_wall += w
        if not same_stage0(fam[0][m], solo):
            fail(f"IBP family stage 0: model {m} differs from its solo stage 0")
    decided = [int(f[0].sum() + f[1].sum()) for f in fam[0]]
    print(f"[IBP family AC grid] M = {len(nets)}, {len(lo)} partitions in {n_chunks} "
          f"chunks: {wall:.3f} s ({len(nets)} solo runs {solo_wall:.3f} s), stage 0 "
          f"decided per model {decided}, equal to each solo run; launches "
          f"{ {k: launch[k] for k in K10} }", flush=True)

    case = case_inputs("AC chunk", nets[0], cfg.with_(mega_chunks=1), canary=False)
    kb, kc = case["kb"], case["kc"]
    boxes = [kb["x_lo"], kb["x_hi"], kb["xp_lo"], kb["xp_hi"]]
    xr, pr = kc["xr"], kc["pr"]
    fb, fb_ms = timed(lambda: engine.role_logit_bounds(stack, *boxes, False), reps)
    fl_, fl_ms = timed(lambda: engine.attack_logits(stack, xr, pr), reps)
    pb, pb_ms = timed(lambda: engine.role_logit_bounds_plain(stack, *boxes, False), 1)
    pl_, pl_ms = timed(lambda: engine.attack_logits_plain(stack, xr, pr), 1)
    _, lib_ms = timed(lambda: (library_forward(stack, xr), library_forward(stack, pr)), reps)
    _, lib_b_ms = timed(lambda: library_interval(stack, boxes), reps)
    B, V = boxes[0].shape[0], boxes[0].shape[1]
    fam_forced = role_bounds_invariance("IBP family chunk", stack, boxes, False, B, fb)
    fam_split = time_split(lambda: engine.role_logit_bounds(stack, *boxes, False),
                           engine._role_bounds_prepare(stack, boxes, B, V, B, False))
    sb_ms = sl_ms = 0.0
    err_b = err_l = 0.0
    for m, net in enumerate(nets):
        sb, t = timed(lambda: engine.role_logit_bounds(net, *boxes, False), reps)
        sb_ms += t
        sl, t = timed(lambda: engine.attack_logits(net, xr, pr), reps)
        sl_ms += t
        if not (all(torch.equal(a[m], b) for a, b in zip(fb, sb))
                and all(torch.equal(a[m], b) for a, b in zip(fl_, sl))):
            fail(f"IBP family chunk: model {m}'s rows 8/9 are not bit-equal to its solo "
                 "rows 13/17")
        e, slack, bad = role_bounds_verdict([t[m] for t in fb], [t[m] for t in pb],
                                            k10_refs(net, boxes, False))
        if role_bounds_fails(e, slack, bad):
            fail(f"IBP family chunk: model {m} bound error {e} x tolerance = {slack} x the "
                 f"widening slack, {bad} bounds miss their float64 reference")
        err_b = max(err_b, max(float((a[m] - b[m]).abs().max()) for a, b in zip(fb, pb)))
        for a, b, x in zip(fl_, pl_, (xr, pr)):
            if tol_ratio(a[m], b[m], logit_scale(net, x)) > 1.0:
                fail(f"IBP family chunk: model {m} logit error past tolerance")
            err_l = max(err_l, float((a[m] - b[m]).abs().max()))
    sizes = [nets[0].in_dim] + list(nets[0].layer_sizes)
    M = len(nets)
    nrole, nrows = 2 * boxes[0].numel() // boxes[0].shape[-1], 2 * xr.numel() // xr.shape[-1]
    rows = {}
    for key, ms, solo, plain, lib, err, cost in (
            ("role_bounds", fb_ms, sb_ms, pb_ms, lib_b_ms, err_b,
             role_bounds_cost(sizes, nrole, M)),
            ("attack_logits", fl_ms, sl_ms, pl_ms, lib_ms, err_l,
             attack_logits_cost(sizes, nrows, M))):
        r = dict(ms=ms, solo_sum_ms=solo, plain_ms=plain, library_ms=lib, max_abs_err=err,
                 M=M, flops=cost[0], bytes=cost[1], launches=launch[key])
        r["bound_ms"], r["bound_by"] = bound(*cost)
        if key == "role_bounds":
            r["geometry"], r["time_split"] = dict(forced_ms=fam_forced), fam_split
        rows[key] = r
        print(f"[IBP family chunk] {key} (M = {M}): {ms:.4f} ms ({M} solo launches "
              f"{solo:.4f} ms), plain {plain:.4f} ms"
              f"{'' if lib is None else f', library {lib:.4f} ms'}, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; bit-equal per model to the "
              "solo launches"
              + (f"; C entry point alone {fam_split['entry_ms']:.4f} ms; bit-equal under "
                 f"forced geometries {fam_forced}" if key == "role_bounds" else ""),
              flush=True)
    return rows


def k10_ladder(work: str) -> dict:
    """Phase 8d: the BaB ladder world on the IBP path (the host frontier's
    non-fused branch: row 13 per batch, row 17 on its undecided boxes) on
    the card and on the CPU: equal ledger rows.  Returns the launches."""
    rep_d, rows_d, lnet, lcfg = ladder_world(work, "cuda", TAIL, **IBP)
    rep_c, rows_c, _, _ = ladder_world(work, "cpu", TAIL, **IBP)
    if rows_d != rows_c or any(rep_d.kernel_launches[k] == 0 for k in K10):
        fail(f"ladder world, IBP: card {rows_d} vs CPU {rows_c}; launches "
             f"{rep_d.kernel_launches}")
    check_outputs(rep_d, lcfg, lnet, "BaB-1", rep_d.kernel_launches)
    print(f"[IBP ladder] card = CPU: {rep_d.counts}; launches {rep_d.kernel_launches}",
          flush=True)
    return rep_d.kernel_launches


def require_native_exact() -> None:
    """Fail unless the native exact core is loaded: phase 8's exact-certify
    runs must not fall back to ``Fraction`` arithmetic on the card's host."""
    from fairify_tpu_torch.ops import exact_native

    if not exact_native.available():
        fail(f"the native exact core is not loaded: {exact_native.build_error}")


def exact_mask_diffs(net, lo, hi, prune, parts) -> int:
    """Masks of the exact pass (certified = candidates − survivors) that
    differ, on partitions ``parts``, from the port's Fraction pass on the
    CPU over the same candidates."""
    import numpy as np

    from fairify_tpu_torch.ops import exact as exact_ops

    ws, bs = net.numpy_params()
    bad = 0
    for p in parts:
        cand = [c[p] for c in prune.candidates]
        cpu = exact_ops.certify_dead_fraction(ws, bs, lo[p], hi[p], cand)
        card = [c - s for c, s in zip(cand, [s[p] for s in prune.surviving])]
        bad += sum(int((a != b).sum()) for a, b in zip(cpu, card))
    return bad


def exact_pass_check(ac_net, ac_cfg) -> dict:
    """Phase 8e: the exact-certify pass over the whole AC grid (16,000
    partitions, AC-S1 widths) through the native exact core, which must be
    loaded: its seconds (``sv_time_s``), and the certified masks of
    EXACT_CPU_PARTS partitions equal to the port's Fraction pass on the
    CPU; a copy with one certified-dead neuron flipped must differ."""
    import copy

    import numpy as np

    from fairify_tpu_torch.verify import pruning, sweep

    require_native_exact()
    _, lo, hi = sweep.build_partitions(ac_cfg)
    prune, _, wall = counted(lambda: pruning.sound_prune_grid(
        ac_net, lo, hi, ac_cfg.sim_size, ac_cfg.seed, chunk=ac_cfg.grid_chunk,
        mega_chunks=ac_cfg.mega_chunks, exact_certify=True))
    parts = np.linspace(0, len(lo) - 1, EXACT_CPU_PARTS).astype(int)
    diffs = exact_mask_diffs(ac_net, lo, hi, prune, parts)
    if diffs:
        fail(f"exact pass: {diffs} masks differ from the CPU Fraction pass")
    p_mut = next((int(p) for p in parts if ((prune.candidates[0][p] == 1)
                                             & (prune.surviving[0][p] == 0)).any()), None)
    if p_mut is None:
        fail("exact pass: no sampled partition has a certified-dead neuron to flip")
    mut = copy.copy(prune)
    mut.surviving = [s.copy() for s in prune.surviving]
    j = int(np.where((prune.candidates[0][p_mut] == 1) & (prune.surviving[0][p_mut] == 0))[0][0])
    mut.surviving[0][p_mut, j] = 1.0
    if exact_mask_diffs(ac_net, lo, hi, mut, [p_mut]) == 0:
        fail("exact pass: a mask with one certified-dead neuron flipped passes the check")
    cert = sum(int((c - s).sum()) for c, s in zip(prune.candidates, prune.surviving))
    s_dead = sum(int(s.sum()) for s in prune.s_deads)
    row = dict(sv_time_s=prune.sv_time_s, prune_wall_s=wall, partitions=len(lo),
               certified=cert, s_deads=s_dead, cpu_checked=EXACT_CPU_PARTS)
    print(f"[exact pass AC grid] {len(lo)} partitions, native core: sv_time_s "
          f"{prune.sv_time_s:.3f} s of a {wall:.3f} s prune pass; {cert} neurons certified "
          f"dead, {s_dead} beyond the IBP criterion; {EXACT_CPU_PARTS} partitions equal "
          "the CPU Fraction pass, a flipped mask fails", flush=True)
    return row


def ibp_gc(work: str, gc_net, gc_cfg) -> dict:
    """Phase 8a: the GC-1 twin on the GC preset with only the engine's
    ``use_crown`` changed (exact-certify on, as the preset has it): sat=2
    unsat=199 unknown=0, card = CPU (ledger, CSV without its timing
    columns, funnel); then the preset on the CROWN path with the exact
    pass on, for its cost beside the exact-off run of phase 3.  Returns
    the launches and the throughput records."""
    from dataclasses import replace

    from fairify_tpu_torch.models.mlp import flagship_net
    from fairify_tpu_torch.verify import sweep

    cfg = gc_cfg.with_(result_dir=os.path.join(work, "gc-ibp"), exact_certify_masks=True,
                       engine=replace(gc_cfg.engine, **IBP))
    rep, launch, wall = run_sweep(gc_net, cfg, "GC-1", required=("sim_and_bounds", "parity")
                                  + K10)
    thr = check_outputs(rep, cfg, gc_net, "GC-1", launch)
    ccfg = cfg.with_(result_dir=os.path.join(work, "gc-ibp-cpu"))
    shutil.rmtree(ccfg.result_dir, ignore_errors=True)
    rep_c = sweep.verify_model(flagship_net(device="cpu"), ccfg, model_name="GC-1",
                               resume=False, device="cpu")
    if (rep.counts != {"sat": 2, "unsat": 199, "unknown": 0}
            or run_rows(cfg, rep) != run_rows(ccfg, rep_c)
            or rep.funnel["states"] != rep_c.funnel["states"]):
        fail(f"GC-1 IBP: card {rep.counts} vs CPU {rep_c.counts}, or the ledger, CSV or "
             "funnel differ")
    decided = rep.counts["sat"] + rep.counts["unsat"]
    print(f"[e2e GC-1 IBP] {rep.counts} = CPU, decided_fraction {thr['decided_fraction']} "
          f"in {wall:.3f} s = {decided / wall:.2f} decided partitions/s; sv_time_s "
          f"{thr['phases_s'].get('prune_exact_certify')}; funnel {thr['funnel']}; phases "
          f"{thr['phases_s']}; launches {launch}", flush=True)
    xcfg = gc_cfg.with_(result_dir=os.path.join(work, "gc-exact"), exact_certify_masks=True)
    rep_x, launch_x, wall_x = run_sweep(gc_net, xcfg, "GC-1", required=(
        "sim_and_bounds", "stage0_certify", "attack_flips", "parity"))
    thr_x = check_outputs(rep_x, xcfg, gc_net, "GC-1", launch_x)
    if rep_x.counts != {"sat": 2, "unsat": 199, "unknown": 0}:
        fail(f"GC-1 CROWN with exact-certify: {rep_x.counts}")
    print(f"[e2e GC-1 CROWN exact-certify] {rep_x.counts} in {wall_x:.3f} s = "
          f"{(rep_x.counts['sat'] + rep_x.counts['unsat']) / wall_x:.2f} decided "
          f"partitions/s; sv_time_s {thr_x['phases_s'].get('prune_exact_certify')}; phases "
          f"{thr_x['phases_s']}; launches {launch_x}", flush=True)
    return dict(launch=launch, thr=thr, wall=wall, crown_exact=dict(
        wall=wall_x, phases=thr_x["phases_s"]))


def ibp_grid(work: str, ac_net, ac_cfg) -> dict:
    """Phase 8b end to end: ``verify_model`` over the whole AC grid on the
    IBP path (the chunk loop: 8 launches each of rows 13 and 17 in stage 0,
    then the host frontier's), phase 5's configuration otherwise (0.02 s
    soft, 30 s hard, Phases S/L/P/E0/E off).  Returns launches and the
    throughput record."""
    from fairify_tpu_torch.verify import sweep
    from fairify_tpu_torch.verify.config import EngineConfig

    cfg = ac_cfg.with_(result_dir=os.path.join(work, "ac-grid-ibp"), soft_timeout_s=0.02,
                       hard_timeout_s=30.0, engine=EngineConfig(**TAIL, max_nodes=1000,
                                                                **IBP))
    n_chunks = -(-len(sweep.build_partitions(cfg)[0]) // cfg.grid_chunk)
    with ShapeLog() as shapes:
        rep, launch, wall = run_sweep(ac_net, cfg, "AC-S1-grid-ibp", required=(
            "sim_and_bounds", "parity", "pgd_attack") + K10)
    shapes.check(launch, "AC grid IBP")
    thr = check_outputs(rep, cfg, ac_net, "AC-S1-grid-ibp", launch)
    if any(launch[k] < n_chunks for k in K10) or launch["sim_and_bounds"] != n_chunks:
        fail(f"AC grid IBP: launches {launch}, expected the chunk loop's {n_chunks}")
    print(f"[AC-S1 grid IBP] {rep.partitions_total} partitions, chunk loop of {n_chunks}: "
          f"{rep.counts} (stage 0 + PGD decided {thr['stage0_decided']}, the host frontier "
          f"and retry {thr['bab_decided']}; decided_fraction {thr['decided_fraction']}) in "
          f"{wall:.3f} s under a 30 s hard budget; funnel {thr['funnel']}; phases "
          f"{thr['phases_s']}; launches {launch}; row-17 launches by rows "
          f"{dict(sorted(shapes.rows.items()))}", flush=True)
    return dict(launch=launch, thr=thr, wall=wall, rows=shapes.rows)


# ---------------------------------------------------------------------------
# Phase 9: the mesh path (rows 14 and 6), harsh pruning (row 3) and the
# standalone α-CROWN bounds (K7)
# ---------------------------------------------------------------------------

# Phase 9c's hard budget (15 s before phase 12 joined the run; its checks
# do not depend on it).
MESH_AC_SPAN, MESH_AC_HARD_S = (0, 2048), 10.0
GC_COUNTS = {"sat": 2, "unsat": 199, "unknown": 0}
K7_ITERS, K7_BOXES = 8, 512
# K7's other launch shapes (boxes), each held and timed: one box, a few
# boxes, every leftover the AC-S1 tails take.
K7_SIZES = (1, 17, 2048)
# Forced K7 geometries (boxes a block, warps): one box on two warps, two
# boxes on four, eight boxes on sixteen; the bounds must not depend on them.
K7_FORCES = ((1, 2), (2, 4), (8, 16))
# Of K7's boxes at most this share may differ from the plain version by
# more than the widening slack (an α path that met a zero gradient, where
# the two versions' rounding may step differently); every box stays sound
# and no looser than plain CROWN.
K7_EXCUSE_SHARE = 0.01


def mesh_gc(work: str, gc_net, gc_cfg) -> dict:
    """Phases 9a and 9b: the GC-1 twin on the GC grid (CROWN, exact-certify
    off) over a 1 x 1 mesh of cuda:0 and over a 3-shard submesh of it
    (ragged shard padding): sat=2 unsat=199 unknown=0, verdicts equal to the
    mesh=None run's, ledger and CSV rows equal to the port's one-shard CPU
    mesh run and to each other; row 14 (role_certify) launches once per
    chunk and shard, row 17 once per chunk, KB and KC never.  Returns the
    launches and the decided partitions/s of the three runs."""
    from fairify_tpu_torch.models.mlp import flagship_net
    from fairify_tpu_torch.parallel.mesh import make_mesh, submesh
    from fairify_tpu_torch.verify import sweep

    n_chunks = -(-len(sweep.build_partitions(gc_cfg)[0]) // gc_cfg.grid_chunk)
    path = ("sim_and_bounds", "role_certify", "attack_logits", "parity")
    rate = lambda rep, wall: (rep.counts["sat"] + rep.counts["unsat"]) / wall
    cfg0 = gc_cfg.with_(result_dir=os.path.join(work, "mesh-gc-none"))
    rep0, launch0, wall0 = run_sweep(gc_net, cfg0, "GC-1",
                                     required=("stage0_certify", "attack_flips"))
    out = {"none": dict(launch=launch0, pps=rate(rep0, wall0), wall=wall0)}
    verdicts = lambda rep: [(o.partition_id, o.verdict) for o in rep.outcomes]
    rows = None
    for tag, mesh, shards in (("1x1", make_mesh(n_parts=1), 1),
                              ("3 shards", submesh(["cuda:0"] * 3), 3)):
        cfg = gc_cfg.with_(result_dir=os.path.join(work, f"mesh-gc-{shards}"))
        rep, launch, wall = run_sweep(gc_net, cfg, "GC-1", required=path, mesh=mesh)
        thr = check_outputs(rep, cfg, gc_net, "GC-1", launch)
        if rows is None:
            ccfg = gc_cfg.with_(result_dir=os.path.join(work, "mesh-gc-cpu"))
            shutil.rmtree(ccfg.result_dir, ignore_errors=True)
            rep_c = sweep.verify_model(flagship_net(device="cpu"), ccfg, model_name="GC-1",
                                       resume=False, device="cpu", mesh=submesh(["cpu"]))
            rows = run_rows(ccfg, rep_c)
        if (rep.counts != GC_COUNTS or verdicts(rep) != verdicts(rep0)
                or run_rows(cfg, rep) != rows or launch["role_certify"] != shards * n_chunks
                or launch["attack_logits"] != n_chunks or launch["stage0_certify"]
                or launch["attack_flips"]
                or abs(thr["partitions_per_sec_per_chip"]
                       - thr["partitions_per_sec"] / shards) > 1e-3):
            fail(f"GC-1 over a mesh ({tag}): {rep.counts}, verdicts equal to mesh=None "
                 f"{verdicts(rep) == verdicts(rep0)}, rows equal to the CPU mesh run "
                 f"{run_rows(cfg, rep) == rows}; launches {launch}; throughput {thr}")
        out[tag] = dict(launch=launch, pps=rate(rep, wall), wall=wall)
        print(f"[mesh GC-1 {tag}] {rep.counts} = mesh=None = the CPU mesh run; "
              f"{out[tag]['pps']:.2f} decided partitions/s in {wall:.3f} s (mesh=None "
              f"{out['none']['pps']:.2f} /s in {wall0:.3f} s); phases {thr['phases_s']}; "
              f"launches {launch}", flush=True)
    return out


def mesh_ac(work: str, ac_net, ac_cfg) -> dict:
    """Phase 9c: the AC-S1 twin over AC partitions 0-2,048 on a 1 x 1 mesh
    and without one.  Stage 0 (the mesh's row 14 + row 17 against the fused
    KB + KC, whose forwards share ``tile_forward``) is bit-equal; then
    verify_model in the slice-3 configuration
    (0.02 s soft, 10 s hard) both ways — the mesh run's BaB is the host
    frontier with row 14 — with the decided fractions printed.  Returns
    the mesh run's launches and both throughput records."""
    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.parallel.mesh import make_mesh
    from fairify_tpu_torch.verify import sweep
    from fairify_tpu_torch.verify.config import EngineConfig
    from fairify_tpu_torch.verify.property import encode

    mesh = make_mesh(n_parts=1)
    s, e = MESH_AC_SPAN
    enc = encode(ac_cfg.query())
    _, lo, hi = sweep.build_partitions(ac_cfg)
    st = {tag: counted(lambda m=m: sweep.stage0_certify_and_attack(
        ac_net, enc, lo[s:e], hi[s:e], ac_cfg, funnel_mod.StageStats(), {}, mesh=m),
        f"AC-S1 stage 0, mesh {tag}") for tag, m in (("none", None), ("mesh", mesh))}
    if not same_stage0(st["none"][0], st["mesh"][0]) or st["mesh"][1]["stage0_certify"]:
        fail(f"AC-S1 0-2048: stage 0 over a mesh differs from mesh=None's (launches "
             f"{st['mesh'][1]})")
    out = {}
    for tag, m in (("none", None), ("mesh", mesh)):
        cfg = ac_cfg.with_(result_dir=os.path.join(work, f"mesh-ac-{tag}"),
                           soft_timeout_s=0.02, hard_timeout_s=MESH_AC_HARD_S,
                           engine=EngineConfig(**SLICE3, max_nodes=1000))
        rep, launch, wall = run_sweep(ac_net, cfg, "AC-S1-twin", span=MESH_AC_SPAN, mesh=m,
                                      required=("sim_and_bounds", "parity", "pgd_attack")
                                      + (("role_certify", "attack_logits")
                                         if m is not None else ()))
        thr = check_outputs(rep, cfg, ac_net, "AC-S1-twin", launch)
        if m is not None and (launch["bab_segment"] or launch["stage0_certify"]):
            fail(f"AC-S1 over a mesh ran the device BaB or the fused stage 0: {launch}")
        out[tag] = dict(launch=launch, thr=thr, wall=wall)
        print(f"[mesh AC-S1 {tag}] partitions {s}-{e}, {MESH_AC_HARD_S} s hard: "
              f"{rep.counts}, decided_fraction {thr['decided_fraction']} in {wall:.3f} s "
              f"(stage 0 + PGD decided {thr['stage0_decided']}; the "
              f"engine and the retry {thr['bab_decided']}, first pass by phase "
              f"{thr['engine_decided']}); phases {thr['phases_s']}; launches {launch}",
              flush=True)
    return out


def mesh_kernels(ac_net, ac_cfg, fam_nets, enc, lo, hi, reps: int) -> dict:
    """Phase 9d: row 14 (KB, certificate alone) on one 2,048-row AC chunk at
    α = 0 and at the host frontier's F = 512 AC-S1 leftovers at α = 8
    against its plain version (``kb_check``); row 6 (M = 4 AC-S1 twins) on
    the chunk bit-equal per model to four solo launches, timed beside their
    sum; K8b and K8a (α = 8) on the leftovers' 512 sign boxes over a 3-shard
    submesh of cuda:0 bit-equal to the unsharded launch.  Returns the rows."""
    import numpy as np
    import torch

    from fairify_tpu_torch.parallel import mesh as mesh_mod
    from fairify_tpu_torch.parallel.mesh import stack_models
    from fairify_tpu_torch.verify import engine

    sizes = [ac_net.in_dim] + list(ac_net.layer_sizes)
    case = case_inputs("AC chunk", ac_net, ac_cfg.with_(mega_chunks=1), canary=False)
    F = min(K7_BOXES, len(lo))
    kb_f, _ = frontier_inputs(enc, lo[:F], hi[:F], 1)
    rows = {}
    for tag, kb, nb, alpha in (("chunk", case["kb"], case["n_boxes"], 0),
                               ("host_frontier", kb_f, F, 8)):
        (ck, _sk, mk), k_ms = timed(lambda: engine.role_certify(ac_net, **kb,
                                                                alpha_iters=alpha), reps)
        (cp, _sp, mp), p_ms = timed(lambda: engine.certify_impl(ac_net, **kb,
                                                                alpha_iters=alpha), 1)
        err, near = kb_check(f"row 14 {tag} alpha={alpha}", ac_net, kb, ck, mk, cp, mp,
                             alpha_iters=alpha)
        fl, by = kb_cost(sizes, nb, enc.n_assign, alpha_iters=alpha)
        r = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err, boxes=nb, alpha_iters=alpha,
                 cert_near_diffs=near, certified=int(ck.sum()), flops=fl, bytes=by)
        r["bound_ms"], r["bound_by"] = bound(fl, by)
        rows[tag] = r
        print(f"[kernel row 14 {tag}] role_certify alpha={alpha} on {nb} boxes: "
              f"{k_ms:.4f} ms (plain {p_ms:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}); margin max_abs_err {err:.3g}, certified {r['certified']}, "
              f"certificates differing at a zero margin {near}", flush=True)
    kb = case["kb"]
    stack = stack_models(fam_nets)
    fam, f_ms = timed(lambda: engine.role_certify(stack, **kb), reps)
    plain, p_ms = timed(lambda: engine.each_model(
        stack, lambda n: engine.certify_impl(n, **kb)), 1)
    solo_ms = 0.0
    for m, net in enumerate(fam_nets):
        solo, t = timed(lambda: engine.role_certify(net, **kb), reps)
        solo_ms += t
        if not all(torch.equal(a[m], b) for a, b in zip(fam, solo)):
            fail(f"row 6: model {m}'s certificate, score or margin is not bit-equal to its "
                 "solo row-14 launch")
    M = len(fam_nets)
    fl, by = kb_cost(sizes, case["n_boxes"], enc.n_assign, M)
    r = dict(ms=f_ms, solo_sum_ms=solo_ms, plain_ms=p_ms, M=M, boxes=case["n_boxes"],
             max_abs_err=float((fam[2] - plain[2]).abs().max()), flops=fl, bytes=by)
    r["bound_ms"], r["bound_by"] = bound(fl, by)
    rows["family_chunk"] = r
    print(f"[kernel row 6] role_certify M = {M} on {case['n_boxes']} boxes: {f_ms:.4f} ms "
          f"({M} solo launches {solo_ms:.4f} ms, plain {p_ms:.4f} ms, margin max_abs_err "
          f"{r['max_abs_err']:.3g}), bound {r['bound_ms']:.4f} ms by {r['bound_by']}; "
          f"bit-equal per model to the solo launches", flush=True)
    mesh3 = mesh_mod.submesh(["cuda:0"] * 3)
    reps3 = mesh_mod.replicated(mesh3, ac_net)
    slo, shi = (a.astype(np.float32) for a in engine.sign_boxes(enc, lo[:F], hi[:F]))
    on = lambda a: torch.as_tensor(a, device="cuda")
    signs = [np.zeros((F, n), np.float32) for n in ac_net.layer_sizes[:-1]]
    flat = lambda tree: [t.cpu().numpy() if torch.is_tensor(t) else t
                         for x in tree for t in (x if isinstance(x, (list, tuple)) else [x])]
    pairs = (
        ("inter_bounds", engine.inter_bounds(ac_net, on(slo), on(shi)),
         mesh_mod.shard_map(mesh3, engine.inter_bounds, reps3, slo, shi)),
        ("sign_bound", engine.sign_bound(ac_net, on(slo), on(shi), [on(g) for g in signs], 8),
         mesh_mod.shard_map(mesh3, lambda n, a, b, *g: engine.sign_bound(n, a, b, list(g), 8),
                            reps3, slo, shi, *signs)))
    for name, whole, sharded in pairs:
        a, b = flat(whole), flat(sharded)
        if len(a) != len(b) or not all(np.array_equal(x, y[:F]) for x, y in zip(a, b)):
            fail(f"{name}: the 3-shard launch over {F} sign boxes differs from the "
                 "unsharded one")
    print(f"[kernel mesh K8] inter_bounds and sign_bound (alpha 8) over {F} AC-S1 sign boxes "
          "in 3 shards (padded to a multiple of 3) = the unsharded launches, bit for bit",
          flush=True)
    return rows


def mesh_worlds(work: str, fam_nets, ac_cfg) -> dict:
    """Phase 9e: the BaB ladder world over a 3-shard mesh in the slice-3
    configuration (Phase S with Phase L, its K8 batches sharded; the host
    frontier with row 14) and on the IBP path (rows 13 and 17 sharded):
    card = CPU; the four AC-S1 twins through ``stage0_families`` over a
    3-shard mesh on partitions 0-2,048 (row 6, then row 9), per model equal
    to the mesh=None family's fused stage 0; and ``uniform_sign_bab`` of
    each twin's first 16 stage-0 leftovers (Phase L off, 64 nodes a root)
    over the mesh equal to the unsharded run: verdicts and node counts.
    Returns the ladder runs' launches."""
    import numpy as np

    from fairify_tpu_torch.parallel.mesh import stack_models, submesh
    from fairify_tpu_torch.verify import engine, sweep
    from fairify_tpu_torch.verify.config import EngineConfig
    from fairify_tpu_torch.verify.property import encode

    out = {}
    for tag, phases, kw in (("slice 3", SLICE3, {}), ("IBP", TAIL, IBP)):
        rep_d, rows_d, lnet, lcfg = ladder_world(work, "cuda", phases, mesh_parts=3, **kw)
        rep_c, rows_c, _, _ = ladder_world(work, "cpu", phases, mesh_parts=3, **kw)
        launch = rep_d.kernel_launches
        if (rows_d != rows_c or rep_d.counts != {"sat": 0, "unsat": 8, "unknown": 0}
                or launch["bab_segment"]
                or not launch["role_certify" if phases is SLICE3 else "role_bounds"]):
            fail(f"ladder world over a mesh, {tag}: card {rows_d} vs CPU {rows_c}; "
                 f"launches {launch}")
        check_outputs(rep_d, lcfg, lnet, "BaB-1", launch)
        out[tag] = launch
        print(f"[mesh ladder {tag}] 3 shards, card = CPU: {rep_d.counts}; launches {launch}",
              flush=True)
    mesh = submesh(["cuda:0"] * 3)
    enc = encode(ac_cfg.query())
    _, lo, hi = sweep.build_partitions(ac_cfg)
    s, e = MESH_AC_SPAN
    cfg = ac_cfg.with_(mega_chunks=0)
    stack = stack_models(fam_nets)
    (fam,), launch, _ = counted(lambda: sweep.stage0_families([stack], enc, lo[s:e], hi[s:e],
                                                              cfg, mesh=mesh),
                                "AC-S1 family over 3 shards")
    (ref,) = sweep.stage0_families([stack], enc, lo[s:e], hi[s:e], cfg)
    if (not all(same_stage0(a, b) for a, b in zip(fam, ref)) or launch["role_certify"] != 3
            or launch["attack_logits"] != 1):
        fail(f"AC-S1 family over a mesh: stage 0 differs from mesh=None's; launches {launch}")
    scfg = EngineConfig(lp_sign=False, sign_max_nodes=64)
    nodes = []
    for m, net in enumerate(fam_nets):
        lenc, llo, lhi = leftovers(net, ac_cfg, 16, 2048)
        got, want = (engine.uniform_sign_bab(net, lenc, llo, lhi, scfg, deadline_s=120.0,
                                             mesh=mm) for mm in (mesh, None))
        if got[0] != want[0] or not np.array_equal(got[1], want[1]):
            fail(f"uniform_sign_bab over a mesh, twin {m}: {got[:2]} vs unsharded {want[:2]}")
        nodes.append(int(got[1].sum()))
    print(f"[mesh AC-S1 twins] stage0_families over 3 shards = mesh=None per model (one "
          f"chunk: {launch['role_certify']} row-6 and {launch['attack_logits']} row-9 "
          f"launches); uniform_sign_bab of 16 leftovers each over 3 shards = unsharded "
          f"(nodes {nodes})", flush=True)
    return out


def harsh_check(ac_net, ac_cfg, reps: int) -> dict:
    """Phase 9f: ``harsh_prune_grid`` over the whole AC grid (16,000
    partitions, one row-3 launch: KA's simulation half) equal bit for bit
    to the candidates of KA's full launch on the same keys, and row 3
    against its plain version by phase 2's KA rule.  Returns the row."""
    import numpy as np
    import torch

    from fairify_tpu_torch.utils.prng import grid_keys, simulate_boxes
    from fairify_tpu_torch.verify import pruning, sweep

    _, lo, hi = sweep.build_partitions(ac_cfg)
    P, S = len(lo), ac_cfg.sim_size
    harsh, launch, wall = counted(lambda: pruning.harsh_prune_grid(ac_net, lo, hi, S,
                                                                   ac_cfg.seed))
    keys = grid_keys(ac_cfg.seed, 0, P, device="cuda")
    lo_t, hi_t = (torch.as_tensor(a.astype(np.float32), device="cuda") for a in (lo, hi))
    full = pruning.sim_and_bounds(ac_net, keys, lo_t, hi_t,
                                  torch.ones(P, dtype=torch.bool, device="cuda"), S)[0]
    if launch["sim_stats"] != 1 or not all(np.array_equal(h, c.cpu().numpy())
                                           for h, c in zip(harsh, full)):
        fail(f"harsh_prune_grid: launches {launch}, or its candidates differ from KA's "
             "full launch")
    k_out, k_ms = timed(lambda: pruning.sim_stats(ac_net, keys, lo_t, hi_t, S), reps)
    p_out, p_ms = timed(lambda: pruning.sim_stats_plain(ac_net, keys, lo_t, hi_t, S), 1)
    err, cnt_bad, cand_bad, near = sim_counts_check(ac_net, keys, lo_t, hi_t, S, k_out, p_out)
    if cnt_bad or cand_bad:
        fail(f"row 3: activation counts off by more than their near-zero samples on "
             f"{cnt_bad} neurons, candidates inconsistent with counts on {cand_bad}")
    split = time_split(lambda: pruning.sim_stats(ac_net, keys, lo_t, hi_t, S),
                       pruning._sim_prepare(ac_net, keys, lo_t, hi_t, S, P, "stats"),
                       split_launches(k_ms))
    # The library yardstick at row 3's own shape: the samples' masked
    # forward as a cuBLAS chain (rows 1 and 2's), over all P partitions.
    torch.cuda.empty_cache()
    sim = simulate_boxes(keys, lo_t, hi_t, S)
    _, lib_ms = timed(lambda: library_sim_forward(ac_net, sim), reps)
    split["library_device_ms"] = graph_ms(lambda: library_sim_forward(ac_net, sim),
                                          split_launches(lib_ms))
    del sim
    torch.cuda.empty_cache()
    sizes = [ac_net.in_dim] + list(ac_net.layer_sizes)
    nsum = sum(sizes[1:])
    fl = 2 * P * S * macs(sizes)
    by = P * (8 + 8 * sizes[0]) + 4 * (macs(sizes) + 2 * nsum) + P * 8 * nsum
    row = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err, partitions=P, near_diffs=near,
               launches=launch["sim_stats"], wall_s=wall, library_ms=lib_ms,
               time_split=split, draw=draw_floor(sizes, P, S),
               dead=int(sum(float(h.sum()) for h in harsh)))
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[harsh AC grid] harsh_prune_grid over {P} partitions in {wall:.3f} s: one row-3 "
          f"launch, candidates = KA's full launch bit for bit ({row['dead']} dead); row 3 "
          f"{k_ms:.4f} ms (C entry point alone {split['entry_ms']:.4f} ms; plain "
          f"{p_ms:.4f} ms, library {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']}, library chain device-only "
          f"{fmt_ms(split['library_device_ms'])}, the draw's floor from its SASS "
          f"{fmt_ms(None if row['draw'] is None else row['draw']['ms'])}); counts "
          f"differing near zero on {near} neurons", flush=True)
    return row


def k7_hold(name, net, lo_t, hi_t, reps: int, widen: bool = True, sound: bool = True) -> dict:
    """K7 on (B, d) boxes against its plain version, ``widen`` passed to
    both: within the widening slack on all but K7_EXCUSE_SHARE of the
    boxes, no looser than plain CROWN (the kernel's own ``iters = 0``
    launch exactly, the plain version's within the slack) and, with
    ``sound``, containing the float64 logits of 32 seeded points per box.
    Times the wrapper (median of ``reps``) and the C entry point alone
    (``time_split``).  Returns the row."""
    import torch

    from fairify_tpu_torch.ops import crown
    from fairify_tpu_torch.ops.interval import SOUND_SLACK_ABS, SOUND_SLACK_REL

    F = len(lo_t)
    run = lambda: crown.alpha_crown_output_bounds(net, lo_t, hi_t, iters=K7_ITERS, widen=widen)
    (klo, khi), k_ms = timed(run, reps)
    (plo, phi), p_ms = timed(lambda: crown.alpha_crown_output_bounds_plain(
        net, lo_t, hi_t, iters=K7_ITERS, widen=widen), 1)
    split = time_split(run, crown._alpha_crown_prepare(net, lo_t, hi_t, K7_ITERS, widen))
    c_lo, c_hi = crown.alpha_crown_output_bounds(net, lo_t, hi_t, iters=0)
    cp_lo, cp_hi = crown.crown_output_bounds(net, lo_t, hi_t)
    slack = SOUND_SLACK_REL * torch.maximum(plo.abs(), phi.abs()) + SOUND_SLACK_ABS
    ratio = torch.maximum((klo - plo).abs(), (khi - phi).abs()) / slack
    excused = int((ratio > 1.0).sum())
    unsound = 0
    if sound:
        ref_lo, ref_hi = f64_sampled_range(net, lo_t, hi_t)
        unsound = int((klo.double() > ref_lo).sum() + (khi.double() < ref_hi).sum())
    looser = int((klo < c_lo).sum() + (khi > c_hi).sum()
                 + (klo < cp_lo - slack).sum() + (khi > cp_hi + slack).sum())
    if unsound or looser or excused > K7_EXCUSE_SHARE * F:
        fail(f"K7 {name}: {unsound} bounds miss a float64 sample, {looser} are looser than "
             f"plain CROWN, {excused} of {F} boxes differ from the plain version by more "
             "than the widening slack")
    sizes = [net.in_dim] + list(net.layer_sizes)
    hidden = macs(sizes[:-1])
    fl = F * (crown_flops(sizes) + K7_ITERS * 8 * hidden + 4 * hidden)
    by = F * (2 * sizes[0] * 4 + 8) + 4 * (macs(sizes) + 2 * sum(sizes[1:]))
    tight = float(((khi - klo) / (c_hi - c_lo)).mean())
    row = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=float(torch.maximum(
        (klo - plo).abs(), (khi - phi).abs()).max()), err_x_slack=float(ratio.max()),
        excused=excused, boxes=F, iters=K7_ITERS, width_vs_crown=tight, time_split=split,
        out=(klo, khi))
    row["bound_ms"], row["bound_by"] = bound(fl, by)
    print(f"[kernel K7 {name}] alpha_crown_output_bounds iters={K7_ITERS}"
          f"{'' if widen else ', widen=False'} on {F} boxes: {k_ms:.4f} ms (C entry point "
          f"alone {split['entry_ms']:.4f} ms, wrapper share {split['wrapper_share']:.3f}; "
          f"plain {p_ms:.4f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}); error "
          f"{row['err_x_slack']:.3f} x the widening slack ({excused} boxes past it); "
          f"{'every box contains its float64 samples and ' if sound else ''}no box is "
          f"looser than CROWN (mean width {tight:.4f} of CROWN's)", flush=True)
    return row


def k7_geometry_checks(name, net, lo_t, hi_t, want) -> dict:
    """K7's bounds under the K7_FORCES geometries (boxes a block, warps)
    must equal the default launch's ``want`` bit for bit; the C entry point
    must refuse a shared-memory size that is not its geometry's and a block
    of no boxes.  Launches of the entry point count nowhere."""
    import torch

    from fairify_tpu_torch.ops import crown

    stream = torch.cuda.current_stream().cuda_stream
    for f in K7_FORCES:
        fn, args, out = crown._alpha_crown_prepare(net, lo_t, hi_t, K7_ITERS, True,
                                                   _geometry_force=f)
        err = fn(*args, stream)
        torch.cuda.synchronize()
        if err or not (torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])):
            fail(f"K7 {name}: (boxes a block, warps) {f} gives other bounds than the default "
                 f"geometry (error {err})")
    fn, args, out = crown._alpha_crown_prepare(net, lo_t, hi_t, K7_ITERS, True)
    bad = {"smem + 16": args[:-1] + (args[-1] + 16,),
           "no boxes a block": args[:-3] + (0,) + args[-2:]}
    refused = {k: fn(*a, stream) for k, a in bad.items()}
    torch.cuda.synchronize()
    if not all(refused.values()):
        fail(f"K7 {name}: the C entry point accepted a wrong geometry ({refused})")
    print(f"[geometry {name}] K7 at (boxes a block, warps) {list(K7_FORCES)}: bit-equal to the "
          f"default; the entry point refuses {sorted(refused)} (errors "
          f"{sorted(refused.values())})", flush=True)
    return dict(forced=[list(f) for f in K7_FORCES], refused=refused)


def k7_check(name, net, lo, hi, reps: int, more: bool = True) -> dict:
    """Phase 9g: ``alpha_crown_output_bounds`` (K7, ``iters`` = 8) on up to
    512 stage-0 leftover boxes (:func:`k7_hold`), one launch through the
    launch counters.  With ``more``: the same boxes under the forced
    geometries (:func:`k7_geometry_checks`), with ``widen=False`` and with
    extra leading axes (bit-equal to the flat launch), and the launch
    shapes K7_SIZES each held and timed.  Returns the row."""
    import numpy as np
    import torch

    from fairify_tpu_torch.ops import crown

    F = min(K7_BOXES, len(lo))
    lo_all, hi_all = (torch.as_tensor(a.astype(np.float32), device="cuda") for a in (lo, hi))
    lo_t, hi_t = lo_all[:F], hi_all[:F]
    _, launch, _ = counted(lambda: crown.alpha_crown_output_bounds(net, lo_t, hi_t,
                                                                   iters=K7_ITERS),
                           f"K7 {name}")
    if launch["alpha_crown"] != 1:
        fail(f"K7 {name}: launches {launch}")
    row = k7_hold(name, net, lo_t, hi_t, reps)
    row["launches"] = launch["alpha_crown"]
    if not more:
        row.pop("out")
        return row
    row["geometry"] = k7_geometry_checks(name, net, lo_t, hi_t, row.pop("out"))
    un = k7_hold(f"{name} unwidened", net, lo_t, hi_t, 1, widen=False, sound=False)
    row["unwidened"] = {k: un[k] for k in ("ms", "max_abs_err", "err_x_slack", "excused")}
    if F % 8 == 0:
        flat = crown.alpha_crown_output_bounds(net, lo_t, hi_t, iters=K7_ITERS)
        lead = crown.alpha_crown_output_bounds(net, lo_t.view(8, F // 8, -1),
                                               hi_t.view(8, F // 8, -1), iters=K7_ITERS)
        if lead[0].shape != (8, F // 8) or not all(torch.equal(a.reshape(-1), b)
                                                    for a, b in zip(lead, flat)):
            fail(f"K7 {name}: boxes of shape (8, {F // 8}, d) give other bounds than (B, d)")
    shapes = {}
    for B in K7_SIZES:
        if B <= len(lo_all):
            r = k7_hold(f"{name} B={B}", net, lo_all[:B], hi_all[:B], reps)
            r.pop("out")
            shapes[str(B)] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "max_abs_err", "err_x_slack", "time_split")}
    row["launch_shapes"] = shapes
    return row


# ---------------------------------------------------------------------------
# Phase 10: the trained nets (fairify_tpu_torch/models/scaled/*.npz)
# ---------------------------------------------------------------------------

# AC partitions whose stage 0 the CPU worker repeats on trained AC-S1.
TRAINED_S0_SPAN = 256
# Seeded domain points per role of each trained net's row-17 check.
TRAINED_POINTS = 4096


def smoke_engine_cfg():
    """The engine configuration of phases 2-4 and of the trained stage 0."""
    from fairify_tpu_torch.verify.config import EngineConfig

    return EngineConfig(frontier_size=512, attack_samples=128, bab_attack_samples=16,
                        soft_timeout_s=10.0)


def trained_stage0_cfg():
    """The AC preset as phases 2-9 run it (exact-certify off)."""
    from fairify_tpu_torch.verify import presets

    return presets.get("AC").with_(exact_certify_masks=False, engine=smoke_engine_cfg())


def trained_stage0(net, cfg, span: int) -> dict:
    """Stage 0 of ``net`` over the grid's first ``span`` partitions as
    verify_model runs it before its tail: the prune (KA), the certificate
    and attack (KB + KC) and the parity pass (KD).  Returns JSON-ready rows
    (partition id, verdict: unsat, sat or open, witness), the sound dead
    masks (per layer, per partition) and the parity column."""
    import numpy as np

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.verify import pruning, sweep
    from fairify_tpu_torch.verify.property import encode

    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    lo, hi = lo[:span], hi[:span]
    prune = pruning.sound_prune_grid(net, lo, hi, cfg.sim_size, cfg.seed, chunk=cfg.grid_chunk,
                                     mega_chunks=cfg.mega_chunks if sweep.use_mega(cfg, None)
                                     else 0, exact_certify=False)
    unsat, sat, wit = sweep.stage0_certify_and_attack(net, enc, lo, hi, cfg,
                                                      stats=funnel_mod.StageStats(), failed={})
    parity = sweep.parity_pass(net, prune, lo, hi, cfg)
    rows = [[p + 1, "unsat" if unsat[p] else "sat" if sat[p] else "open",
             [np.asarray(c).tolist() for c in wit[p]] if p in wit else None]
            for p in range(len(lo))]
    return json.loads(json.dumps(dict(
        rows=rows, dead=[np.asarray(d).astype(int).tolist() for d in prune.st_deads],
        parity=np.asarray(parity, dtype=np.float64).tolist())))


def trained_stage0_vs_cpu(card: dict, cpu: dict) -> dict:
    """Card = CPU on trained AC-S1's stage 0: rows (id, verdict, witness)
    equal, or the run fails; the partitions whose dead masks or parity
    differ are counted and printed."""
    if card["rows"] != cpu["rows"]:
        bad = [(g, w) for g, w in zip(card["rows"], cpu["rows"]) if g != w]
        fail(f"trained AC-S1 stage 0, card vs CPU: {len(bad)} rows differ, first {bad[:3]}")
    n = len(card["rows"])
    masks = sum(1 for p in range(n) if any(c[p] != w[p] for c, w in zip(card["dead"],
                                                                         cpu["dead"])))
    parity = sum(1 for a, b in zip(card["parity"], cpu["parity"]) if a != b)
    counts = {v: sum(1 for r in card["rows"] if r[1] == v) for v in ("unsat", "sat", "open")}
    print(f"[card = CPU trained AC-S1] stage 0 over AC partitions 0-{n}: {counts}; ledger "
          f"rows (id, verdict, witness) equal; dead masks differ on {masks}, parity on "
          f"{parity} partitions", flush=True)
    return dict(counts=counts, masks_differ=masks, parity_differ=parity)


def trained_nets(device: str) -> dict:
    """The four trained nets from their ``.npz`` exports (numpy only)."""
    from fairify_tpu_torch.models import ingest

    return {name: ingest.load_trained(name, device) for name in sorted(ingest.TRAINED)}


def trained_forward_checks(nets: dict) -> dict:
    """Row 17 (``attack_logits``) of each trained net on TRAINED_POINTS
    seeded integer points per role of its domain (adult for AC, bank for
    BM), held against the float64 forward (``forward_np``): every logit
    within TOL_REL of its rounding scale |h| @ |W| + |b| + TOL_ABS.
    Returns per net the error as a multiple of the tolerance."""
    import numpy as np
    import torch

    from fairify_tpu_torch.data.domains import get_domain
    from fairify_tpu_torch.models.mlp import forward_np
    from fairify_tpu_torch.verify import engine

    out = {}
    for name, net in nets.items():
        lo, hi = get_domain("adult" if name.startswith("AC") else "bank").lo_hi()
        rng = np.random.default_rng(0)
        x = rng.integers(lo.astype(np.int64), hi.astype(np.int64) + 1,
                         size=(2, TRAINED_POINTS, len(lo))).astype(np.float32)
        xt = torch.as_tensor(x, device="cuda")
        k = engine.attack_logits(net, xt[0], xt[1])
        ws, bs = net.numpy_params()
        err = 0.0
        for r in range(2):
            f64 = torch.as_tensor(forward_np(ws, bs, x[r]), device="cuda")
            scale = logit_scale(net, xt[r]).double()
            tol = TOL_REL * torch.maximum(f64.abs(), scale) + TOL_ABS
            err = max(err, float(((k[r].double() - f64).abs() / tol).max()))
        if not err <= 1.0:
            fail(f"trained {name}: row-17 logits {err} x the tolerance from float64")
        out[name] = err
    print(f"[trained nets] row 17 on {TRAINED_POINTS} seeded domain points per role, against "
          f"float64: error x tolerance {json.dumps(out)}", flush=True)
    return out


class LatticeTally:
    """How Phase E0's and Phase E's roots end, counted from outside the
    package: ``ops.lattice.decide_box_exhaustive``, its margin resolvers
    and ``_EvidenceMismatch`` are swapped for counting wrappers (a counting
    subclass of the exception: every raise counts), and
    ``engine.lattice_phase`` marks Phase E.  A root's end: ``sat_flip`` (a
    certain flip of the scan, exact-validated), ``sat_margin`` (a margin
    cell settled by the host ladder), ``unsat``, ``unknown_mismatch`` (an
    evidence mismatch: the masked-net quirk where the net is masked),
    ``unknown_deadline``; keyed by phase and by whether the net is masked
    (the heuristic retry's nets).  With relaxed attributes a flip and a
    margin cell both end in ``engine.decide_leaf`` inside the scan's
    closures, so an RA root's SAT counts as ``sat_ra``."""

    def __enter__(self):
        from fairify_tpu_torch.ops import lattice as lat
        from fairify_tpu_torch.verify import engine

        self.ends, self.mismatches, self._in_e, self._cur = {}, 0, False, None
        self._saved = (lat._EvidenceMismatch, lat.decide_box_exhaustive, lat._resolve_margin,
                       lat._resolve_signs, engine.lattice_phase)
        mismatch, decide, margin, signs, phase_e = self._saved
        tally = self

        class Counting(mismatch):
            def __init__(self, *args):
                super().__init__(*args)
                tally.mismatches += 1
                if tally._cur is not None:
                    tally._cur["mismatch"] = True

        def settled(fn):
            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                if out is not None and tally._cur is not None:
                    tally._cur["margin"] = True
                return out
            return wrapped

        def decide_counted(net, enc, *args, **kw):
            outer, self._cur = self._cur, {"margin": False, "mismatch": False}
            try:
                verdict, ce = decide(net, enc, *args, **kw)
                cur = self._cur
            finally:
                self._cur = outer
            sat = "sat_ra" if enc.eps and len(enc.ra_idx) else (
                "sat_margin" if cur["margin"] else "sat_flip")
            end = {"sat": sat, "unsat": "unsat"}.get(
                verdict, "unknown_mismatch" if cur["mismatch"] else "unknown_deadline")
            masked = any(bool((m == 0).any()) for m in net.masks)
            key = f"{'E' if self._in_e else 'E0'}{' masked' if masked else ''}"
            self.ends.setdefault(key, {}).setdefault(end, 0)
            self.ends[key][end] += 1
            return verdict, ce

        def phase_e_marked(*args, **kw):
            self._in_e = True
            try:
                return phase_e(*args, **kw)
            finally:
                self._in_e = False

        lat._EvidenceMismatch = Counting
        lat.decide_box_exhaustive = decide_counted
        lat._resolve_margin = settled(margin)
        lat._resolve_signs = settled(signs)
        engine.lattice_phase = phase_e_marked
        return self

    def __exit__(self, *exc):
        from fairify_tpu_torch.ops import lattice as lat
        from fairify_tpu_torch.verify import engine

        (lat._EvidenceMismatch, lat.decide_box_exhaustive, lat._resolve_margin,
         lat._resolve_signs, engine.lattice_phase) = self._saved


# Phase 10b's runs of trained AC-S1 in the default configuration: phase 6's
# stress-AC cell, then the rest of the 4,096-partition prefix that the JAX
# package's stress-AC-scaled AC-S1 row attempted (VARIANTS.md), whose
# decided counts the two runs must add up to when they decide everything.
TRAINED_DEFAULT = (("stress-AC", (0, 1024)), ("stress-AC", (1024, 4096)))
# That row's decided counts (VARIANTS.md:198-199: 4,096 partitions attempted,
# none unknown).
JAX_STRESS_AC_S1 = {"sat": 993, "unsat": 3103, "unknown": 0}


def trained_default(work: str, net, preset: str, span) -> dict:
    """Phase 10b: trained AC-S1 in phase 6's configuration on ``preset``
    partitions ``span`` (``EngineConfig(max_nodes=1000)``, 0.1 s soft, 75 s
    hard), under :class:`LatticeTally`: the counts, decided fraction,
    first-pass decisions by engine phase (E0's ``lattice_first``, Phase
    P's ``pair``), how E0's and E's roots end and how often
    ``_EvidenceMismatch`` was raised.  Returns the summary."""
    from fairify_tpu_torch.verify import presets
    from fairify_tpu_torch.verify.config import EngineConfig

    cfg = presets.get(preset).with_(
        result_dir=os.path.join(work, f"default-{preset}-trained-{span[0]}"),
        exact_certify_masks=False, soft_timeout_s=DEFAULT_SOFT_S,
        hard_timeout_s=DEFAULT_HARD_S, engine=EngineConfig(max_nodes=1000))
    label = f"{preset} default, trained AC-S1, {span[0]}-{span[1]}"
    with LatticeTally() as tally:
        rep, launch, wall = run_sweep(net, cfg, "AC-S1", span=span, required=DEFAULT_PATH[:4],
                                      label=label)
    thr = check_outputs(rep, cfg, net, "AC-S1", launch)
    c, ph = rep.counts, thr["phases_s"]
    e0 = tally.ends.get("E0", {})
    out = dict(counts=c, decided_fraction=thr["decided_fraction"], wall_s=wall,
               first_pass=thr["engine_decided"], lattice_ends=tally.ends,
               evidence_mismatches=tally.mismatches, stage0_decided=thr["stage0_decided"],
               bab_decided=thr["bab_decided"], launches=launch,
               retry=[sum(o.h_success for o in rep.outcomes),
                      sum(o.h_attempt for o in rep.outcomes)],
               t_pair=ph.get("engine_pair", 0.0))
    print(f"[{label}] sat {c['sat']} unsat {c['unsat']} unknown {c['unknown']}, "
          f"decided_fraction {thr['decided_fraction']} in {wall:.3f} s (stage 0 + PGD "
          f"decided {thr['stage0_decided']}; the engine and the retry {thr['bab_decided']}; "
          f"first pass by phase {thr['engine_decided']}; retry {out['retry'][0]} of "
          f"{out['retry'][1]} tried); E0 roots end {json.dumps(e0)} (certain flips "
          f"{e0.get('sat_flip', 0)}, margin cells {e0.get('sat_margin', 0)}); every lattice "
          f"root by phase {json.dumps(tally.ends)}; _EvidenceMismatch raised "
          f"{tally.mismatches} times; engine t_lattice {ph.get('engine_lattice', 0.0):.3f} s, "
          f"t_pair {ph.get('engine_pair', 0.0):.3f} s, t_lp {ph.get('engine_lp', 0.0):.3f} s; "
          f"funnel {thr['funnel']}; launches {launch}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the sweep through the kernels
# ---------------------------------------------------------------------------


def slot_round_bucket(n: int) -> int:
    """The bucket of a K6 segment with n live slot-rounds: the next power
    of two (at least 64)."""
    return max(64, 1 << max(0, n - 1).bit_length())


def live_bucket(n: int) -> int:
    """The bucket of a K8a launch over n live rows: the next power of two."""
    return 1 << max(0, n - 1).bit_length()


# The first launch's inputs of every K8a bucket (alpha_iters, live_bucket),
# KB bucket (alpha_iters, boxes, models, live_bucket), K8b bucket (phase,
# live_bucket) and row-13 bucket (mode, role boxes, live_bucket, models) met
# in any window of the run.
CERT_CASES = {"sign_bound": {}, "stage0_certify": {}, "inter_bounds": {},
              "role_bounds": {}}
# Every window of the run (run_sweep, counted): (label, ShapeLog, launches).
WINDOWS = []


class ShapeLog:
    """Within ``with ShapeLog() as log``, the launches of K5 by its batch B
    (``log.pgd``), of the attack forward by its row count (``log.rows``),
    of K6 by α and live slot-rounds (``log.bab``: (alpha_iters,
    :func:`slot_round_bucket` of the segment's ``nodes`` sum) -> launches,
    with the first launch of each bucket's inputs in ``log.bab_case``), of
    K8a by α and live rows (``log.sign_bound``: (alpha_iters,
    :func:`live_bucket`) -> launches) and of KB by α, boxes, models and
    live boxes (``log.stage0_certify``: (alpha_iters, N, M,
    :func:`live_bucket`) -> launches; rows 14 and 6 included), of K8b by
    engine phase and live rows (``log.inter_bounds``: ("L" or "P",
    :func:`live_bucket`) -> launches; "P" inside
    ``pair_lp_phase``) and of row 13 by mode, role boxes, live rows and
    models (``log.role_bounds``: ("ibp" or "crown", 2 B V, live_bucket, M)
    -> launches), the first launch of each K8a, KB, K8b and row-13 bucket's
    inputs kept in CERT_CASES, and of KA, row 3 and KD by kind, rows and
    live rows (``log.sim``: ("ka", "stats" or "kd", rows, live) ->
    launches): the split of one run's launch count by shape.  It wraps the
    launch helpers and counts beside the kernels' own counters."""

    def __enter__(self):
        import torch

        from fairify_tpu_torch.verify import engine

        from fairify_tpu_torch.verify import pruning

        self.pgd, self.rows, self.bab, self.bab_case = {}, {}, {}, {}
        self.sign_bound, self.stage0_certify = {}, {}
        self.inter_bounds, self.role_bounds, self.sim = {}, {}, {}
        self._phase_p = False
        self._saved = (engine._pgd_attack_launch, engine._launch_attack_logits,
                       engine._bab_segment_launch, engine._sign_bound_launch,
                       engine._kb_launch, engine._inter_bounds_launch,
                       engine._role_bounds_launch, engine.pair_lp_phase)
        self._saved_sim = pruning._sim_launch
        pgd, logits, bab, k8a, kb, k8b, k10b, phase_p = self._saved
        sim = self._saved_sim

        def sim_launch(net, keys, lo, hi, sim_size, live, kind, *args, **kw):
            key = (kind, int(lo.shape[0]), int(live))
            self.sim[key] = self.sim.get(key, 0) + 1
            return sim(net, keys, lo, hi, sim_size, live, kind, *args, **kw)

        pruning._sim_launch = sim_launch
        keep = lambda args: [a.clone() if torch.is_tensor(a) else
                             [t.clone() for t in a] if isinstance(a, list) else a
                             for a in args]

        def pgd_launch(net, lo, *args, **kw):
            self.pgd[lo.shape[0]] = self.pgd.get(lo.shape[0], 0) + 1
            return pgd(net, lo, *args, **kw)

        def logits_launch(net, x_roles, *args, **kw):
            n = 2 * x_roles.numel() // x_roles.shape[-1]
            self.rows[n] = self.rows.get(n, 0) + 1
            return logits(net, x_roles, *args, **kw)

        def bab_launch(net, *args, **kw):
            kept = keep(args)
            out = bab(net, *args, **kw)
            key = (int(args[-1]), slot_round_bucket(int(out["nodes"].sum())))
            self.bab[key] = self.bab.get(key, 0) + 1
            self.bab_case.setdefault(key, (net, kept))
            return out

        def k8a_launch(net, *args, **kw):  # lo, hi, signs, alpha_iters, with_ab, live
            key = (int(args[3]), live_bucket(int(args[5])))
            self.sign_bound[key] = self.sign_bound.get(key, 0) + 1
            if key not in CERT_CASES["sign_bound"]:
                CERT_CASES["sign_bound"][key] = (net, keep(args))
            return k8a(net, *args, **kw)

        def kb_launch(net, *args, **kw):  # the role and partition boxes, ..., alpha_iters
            n = int(args[10].shape[0])
            live = n if kw.get("live") is None else int(kw["live"])
            key = (int(args[-1]), n, getattr(net, "n_models", 1), live_bucket(live))
            self.stage0_certify[key] = self.stage0_certify.get(key, 0) + 1
            if key not in CERT_CASES["stage0_certify"]:
                CERT_CASES["stage0_certify"][key] = (net, keep(args), live)
            return kb(net, *args, **kw)

        def k8b_launch(net, lo, hi, live, **kw):
            key = ("P" if self._phase_p else "L", live_bucket(int(live)))
            self.inter_bounds[key] = self.inter_bounds.get(key, 0) + 1
            if key not in CERT_CASES["inter_bounds"]:
                CERT_CASES["inter_bounds"][key] = (net, keep([lo, hi, live]))
            return k8b(net, lo, hi, live, **kw)

        def k10b_launch(net, boxes, B, V, live, use_crown, **kw):
            key = ("crown" if use_crown else "ibp", 2 * int(B) * int(V),
                   live_bucket(int(live)), getattr(net, "n_models", 1))
            self.role_bounds[key] = self.role_bounds.get(key, 0) + 1
            if key not in CERT_CASES["role_bounds"]:
                CERT_CASES["role_bounds"][key] = (net, [keep(boxes), B, V, live, use_crown])
            return k10b(net, boxes, B, V, live, use_crown, **kw)

        def pair_phase(*args, **kw):
            self._phase_p = True
            try:
                return phase_p(*args, **kw)
            finally:
                self._phase_p = False

        (engine._pgd_attack_launch, engine._launch_attack_logits, engine._bab_segment_launch,
         engine._sign_bound_launch, engine._kb_launch, engine._inter_bounds_launch,
         engine._role_bounds_launch, engine.pair_lp_phase) = (
            pgd_launch, logits_launch, bab_launch, k8a_launch, kb_launch, k8b_launch,
            k10b_launch, pair_phase)
        return self

    def __exit__(self, *exc):
        from fairify_tpu_torch.verify import engine, pruning

        pruning._sim_launch = self._saved_sim
        (engine._pgd_attack_launch, engine._launch_attack_logits, engine._bab_segment_launch,
         engine._sign_bound_launch, engine._kb_launch, engine._inter_bounds_launch,
         engine._role_bounds_launch, engine.pair_lp_phase) = self._saved
        return False

    def check(self, launch: dict, what: str) -> None:
        """Fails unless the split adds up to the kernels' own counts of the
        same run (``launch``, from :func:`run_sweep`): row 17's helper also
        carries Phase S's role logits."""
        want_rows = launch["attack_logits"] + launch["role_logits"]
        if sum(self.pgd.values()) != launch["pgd_attack"] or sum(
                self.rows.values()) != want_rows or sum(
                self.bab.values()) != launch["bab_segment"]:
            fail(f"{what}: launches by shape K5 {self.pgd}, row 17 {self.rows}, K6 "
                 f"{self.bab} do not add up to the counters' pgd_attack "
                 f"{launch['pgd_attack']}, attack_logits + role_logits {want_rows}, "
                 f"bab_segment {launch['bab_segment']}")

    def check_cert(self, launch: dict, what: str) -> None:
        """Fails unless the K8a, KB, K8b and row-13 splits add up to the
        counters' sign_bound, stage0_certify + role_certify, inter_bounds and
        role_bounds of the same run, and the KA, row-3 and KD launches by
        (kind, rows, live rows) to sim_and_bounds, sim_stats and parity."""
        for kind, counter in (("ka", "sim_and_bounds"), ("stats", "sim_stats"),
                              ("kd", "parity")):
            n = sum(v for k, v in self.sim.items() if k[0] == kind)
            if n != launch[counter]:
                fail(f"{what}: {kind} launches by shape {self.sim} do not add up to the "
                     f"counter's {counter} {launch[counter]}")
        kb = launch["stage0_certify"] + launch["role_certify"]
        if sum(self.sign_bound.values()) != launch["sign_bound"] or sum(
                self.stage0_certify.values()) != kb or sum(
                self.inter_bounds.values()) != launch["inter_bounds"] or sum(
                self.role_bounds.values()) != launch["role_bounds"]:
            fail(f"{what}: launches by shape K8a {self.sign_bound}, KB "
                 f"{self.stage0_certify}, K8b {self.inter_bounds}, row 13 "
                 f"{self.role_bounds} do not add up to the counters' sign_bound "
                 f"{launch['sign_bound']}, stage0_certify + role_certify {kb}, "
                 f"inter_bounds {launch['inter_bounds']}, role_bounds "
                 f"{launch['role_bounds']}")


class ResimClock:
    """Within ``with ResimClock() as c``, the wall time of every
    ``sweep.parity_resim`` call (the heuristic retry's parity of one
    partition: its K12 launch, the one sync and the two host forwards) in
    ``c.calls``."""

    def __enter__(self):
        from fairify_tpu_torch.verify import sweep

        self.calls = []
        self._saved = sweep.parity_resim

        def clocked(*args, **kw):
            t0 = time.perf_counter()
            out = self._saved(*args, **kw)
            self.calls.append(time.perf_counter() - t0)
            return out

        sweep.parity_resim = clocked
        return self

    def __exit__(self, *exc):
        from fairify_tpu_torch.verify import sweep

        sweep.parity_resim = self._saved
        return False

    def summary(self, label: str) -> dict:
        n = len(self.calls)
        out = dict(calls=n, total_s=sum(self.calls),
                   mean_ms=1e3 * sum(self.calls) / n if n else None,
                   median_ms=1e3 * sorted(self.calls)[n // 2] if n else None)
        print(f"[parity_resim, {label}] {n} calls, {out['total_s']:.4f} s in all; ms a call "
              f"mean {fmt_ms(out['mean_ms'])}, median {fmt_ms(out['median_ms'])}", flush=True)
        return out


def bab_by_shape(tails: dict) -> dict:
    """K6 at the shapes of the AC-S1 tails' launches (``tails``: tag ->
    ShapeLog): every (α, slot-round bucket) timed on its first launch's
    inputs, the most frequent bucket of the slice-2 tail also held against
    the plain version.  Returns, per tail, the launches by bucket with the
    bucket's time, bound and launches x (time - bound), and the frequent
    bucket's row."""
    cases, rows = {}, {}
    for tags in tails.values():
        cases.update({k: v for k, v in tags.bab_case.items() if k not in cases})
    freq = max(tails["slice 2"].bab.items(), key=lambda kv: (kv[1], kv[0]))[0]
    for key, (net, args) in sorted(cases.items()):
        st = dict(zip(("q_lo", "q_hi", "q_root", "q_live", "found", "wit_a", "wit_b",
                       "wit_pt"), args[:8]))
        c = dict(zip(("slot_ok", "root_valid", "assign_vals", "pa_mask", "ra_mask", "eps",
                      "valid_pair", "branch_mask"), args[8:16]))
        rows[key] = check_bab(f"AC-S1 tail K6 {key}", net, st, c, key[0], rounds=args[16],
                              reps=3, plain=key == freq)
    out = {"frequent": dict(rows[freq], alpha_iters=freq[0], bucket=freq[1])}
    for tag, log in tails.items():
        out[tag] = {f"alpha{a}:<={b}": dict(
            launches=n, ms=rows[(a, b)]["ms"], bound_ms=rows[(a, b)]["bound_ms"],
            live_rounds=rows[(a, b)]["live_rounds"],
            excess_s=n * (rows[(a, b)]["ms"] - rows[(a, b)]["bound_ms"]) / 1e3)
            for (a, b), n in sorted(log.bab.items())}
        print(f"[K6 by shape, {tag}] " + ", ".join(
            f"{k}: {v['launches']} x ({v['ms']:.3f} - {v['bound_ms']:.3f}) ms"
            for k, v in out[tag].items())
              + "; launches x (time - bound) "
              f"{sum(v['excess_s'] for v in out[tag].values()):.2f} s", flush=True)
    return out


def cert_by_shape(live_window: str = "AC-S1 tail, slice 3") -> dict:
    """K8a, KB, K8b and row 13 at the shapes of the run's windows (WINDOWS):
    every bucket met (CERT_CASES) timed on its first launch's inputs (the
    launch helper, host work included), with its bound on its live rows;
    per window that launched any of them, its launches by bucket and
    launches x (time - bound).  The K8a launch of ``live_window``'s most
    frequent bucket over its live rows must equal the full launch of the
    same rows bit for bit (and, when that bucket's launch had no padded
    row, the most frequent bucket's that had).  Returns, per kernel, the
    buckets' rows and the windows' splits, and the live-row check."""
    import torch

    from fairify_tpu_torch.verify import engine

    sizes_of = lambda net: [net.in_dim] + list(net.layer_sizes)
    name = {"sign_bound": lambda k: f"alpha{k[0]}:<={k[1]}",
            "stage0_certify": lambda k: f"alpha{k[0]}:N{k[1]}:M{k[2]}:<={k[3]}",
            "inter_bounds": lambda k: f"{k[0]}:<={k[1]}",
            "role_bounds": lambda k: f"{k[0]}:R{k[1]}:<={k[2]}:M{k[3]}"}
    buckets = {k: {} for k in name}
    for key, (net, args) in sorted(CERT_CASES["sign_bound"].items()):
        lo, hi, signs, alpha, _, live = args
        _, ms = timed(lambda: engine._sign_bound_launch(net, lo, hi, signs, alpha, False,
                                                        live), 3)
        b_ms, b_by = bound(*sign_bound_cost(sizes_of(net), live, alpha))
        buckets["sign_bound"][key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, live=live,
                                          rows=int(lo.shape[0]))
    for key, (net, args, live) in sorted(CERT_CASES["stage0_certify"].items()):
        _, ms = timed(lambda: engine._kb_launch(net, *args, live=live), 3)
        V = int(args[10].shape[1])
        b_ms, b_by = bound(*kb_cost(sizes_of(net), live, V, key[2], key[0]))
        buckets["stage0_certify"][key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, V=V,
                                              live=live)
    for key, (net, (lo, hi, live)) in sorted(CERT_CASES["inter_bounds"].items()):
        _, ms = timed(lambda: engine._inter_bounds_launch(net, lo, hi, live), 3)
        b_ms, b_by = bound(*inter_bounds_cost(sizes_of(net), live))
        buckets["inter_bounds"][key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, live=live,
                                            rows=int(lo.shape[0]))
    for key, (net, (boxes, B, V, live, crown)) in sorted(CERT_CASES["role_bounds"].items()):
        _, ms = timed(lambda: engine._role_bounds_launch(net, boxes, B, V, live, crown), 3)
        b_ms, b_by = bound(*role_bounds_cost(sizes_of(net), 2 * live * V, key[3], crown))
        buckets["role_bounds"][key] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by, live=live,
                                           boxes=B, V=V)
    out = {k: {"buckets": {name[k](b): r for b, r in v.items()}, "windows": {}}
           for k, v in buckets.items()}
    for label, log, _ in WINDOWS:
        for kernel, tag in (("sign_bound", "K8a"), ("stage0_certify", "KB"),
                            ("inter_bounds", "K8b"), ("role_bounds", "row 13")):
            split = getattr(log, kernel)
            if not split:
                continue
            rows = {name[kernel](k): dict(
                launches=n, ms=buckets[kernel][k]["ms"], bound_ms=buckets[kernel][k]["bound_ms"],
                excess_s=n * (buckets[kernel][k]["ms"] - buckets[kernel][k]["bound_ms"]) / 1e3)
                for k, n in sorted(split.items())}
            win = out[kernel]["windows"]
            key = label if label not in win else f"{label} #{sum(w.startswith(label) for w in win) + 1}"
            win[key] = dict(rows, excess_s=sum(r["excess_s"] for r in rows.values()))
            print(f"[{tag} by shape, {key}] " + ", ".join(
                f"{b}: {r['launches']} x ({r['ms']:.3f} - {r['bound_ms']:.3f}) ms"
                for b, r in rows.items())
                  + f"; launches x (time - bound) {win[key]['excess_s']:.3f} s", flush=True)
    log = next((w for label, w, _ in WINDOWS if label == live_window), None)
    if log is None or not log.sign_bound:
        fail(f"{live_window}: no K8a launch to check live rows on")
    order = sorted(log.sign_bound.items(), key=lambda kv: (-kv[1], kv[0]))
    keys = [order[0][0]]
    padded = [k for k, _ in order if CERT_CASES["sign_bound"][k][1][5]
              < CERT_CASES["sign_bound"][k][1][0].shape[0]]
    if padded and padded[0] not in keys:
        keys.append(padded[0])
    flat = lambda o: list(o[:3]) + list(o[3]) + list(o[4]) + [o[5]]
    checked = []
    for key in keys:
        net, (lo, hi, signs, alpha, _, live) = CERT_CASES["sign_bound"][key]
        part = engine._sign_bound_launch(net, lo, hi, signs, alpha, True, live)
        full = engine._sign_bound_launch(net, lo, hi, signs, alpha, True, lo.shape[0])
        if not all(torch.equal(a, b) for a, b in zip(flat(part), flat(full))):
            fail(f"K8a {name['sign_bound'](key)}: the launch over {live} live rows differs "
                 f"from the full launch of its {lo.shape[0]} rows")
        checked.append(dict(bucket=name["sign_bound"](key), live=live, rows=int(lo.shape[0])))
    print(f"[K8a live rows, {live_window}] most frequent buckets {checked}: the live-row "
          "launch equals the full launch bit for bit", flush=True)
    out["sign_bound"]["live_check"] = checked
    return out


def run_sweep(net, cfg, model_name: str, required=(), span=None, mesh=None, label=None):
    """verify_model (over ``mesh`` when given) with every launch count
    zeroed just before; returns (report, launch counts, wall seconds).
    Fails if a kernel of ``required`` never launched in the run.  The run
    is one window of WINDOWS (``label``, by default the model, preset, span
    and mesh), whose K8a and KB launches by shape add up to the counters."""
    import torch

    from fairify_tpu_torch.obs import launches
    from fairify_tpu_torch.verify import sweep

    shutil.rmtree(cfg.result_dir, ignore_errors=True)
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    with ShapeLog() as shapes:
        rep = sweep.verify_model(net, cfg, model_name=model_name, resume=False,
                                 partition_span=span, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.counts()
    label = label or f"{model_name} {cfg.name}" + (
        f" {span[0]}-{span[1]}" if span else "") + (" mesh" if mesh is not None else "")
    shapes.check_cert(counts, label)
    WINDOWS.append((label, shapes, counts))
    missing = [k for k in required if counts[k] == 0]
    if missing:
        fail(f"{model_name}: kernels never launched on the main path: {missing}")
    return rep, counts, wall


def check_outputs(rep, cfg, net, model_name: str, counts: dict) -> dict:
    """Ledger rows CRC-valid and complete; every SAT witness exact; the
    throughput record's launches those counted in ``counts``.  Returns the
    throughput record."""
    import numpy as np

    from fairify_tpu_torch.resilience import integrity
    from fairify_tpu_torch.verify import engine, sweep

    path = sweep.ledger_path(cfg, rep.sink_name)
    with open(path) as fp:
        recs = [json.loads(line) for line in fp if line.strip()]
    good, bad = integrity.verify_records(recs)
    if bad or len(good) != rep.partitions_total or any("_crc" not in r for r in recs):
        fail(f"{model_name}: ledger rows {len(recs)}, CRC-invalid {bad}")
    reasons = {"deadline", "budget", "frontier", "frontier:overflow", "frontier:hard"}
    odd = [r for r in good if r["verdict"] == "unknown" and "failure" not in r
           and r.get("engine_reason") not in reasons]
    if odd:
        fail(f"{model_name}: unknown rows without an engine reason: {odd[:3]}")
    weights, biases = net.numpy_params()
    for o in rep.outcomes:
        if o.verdict == "sat":
            x, xp = (np.asarray(c, dtype=np.int64) for c in o.counterexample)
            if not engine.validate_pair(weights, biases, x, xp):
                fail(f"{model_name}: SAT witness of partition {o.partition_id} "
                     "fails its exact replay")
    thr = os.path.join(cfg.result_dir, f"{cfg.name}-{rep.sink_name}.throughput.json")
    with open(thr) as fp:
        t = json.load(fp)
    if (not np.isfinite(t["partitions_per_sec"]) or t["device"]["platform"] != "gpu"
            or t["kernel_launches"] != counts
            or t["launches_per_model"] != sum(counts.values())):
        fail(f"{model_name}: bad throughput record {t} (launches counted {counts})")
    return t


# Slice-2 configuration of the refinement tail: Phases S, L, P and E0/E
# off, everything else at its default (pgd 60 x 96, alpha_iters 8, a
# 512-slot queue, 8 rounds per segment, integrity on).  The slice-3
# configuration turns S, L and P back on (E0/E need K9).
TAIL = dict(sign_bab=False, lp_sign=False, lp_pair=False, lattice_exhaustive=False)
SLICE3 = dict(lattice_exhaustive=False)


def ladder_world(work: str, device: str, phases=TAIL, mesh_parts: int = 0, **engine_kw):
    """bench.py's _bab_ladder world (8 German-derived partitions that all
    reach the engine BaB) on ``device`` in the configuration ``phases``,
    over a mesh of ``mesh_parts`` shards of that device when nonzero:
    (report, ledger rows, net, config)."""
    from fairify_tpu_torch.data.domains import get_domain
    from fairify_tpu_torch.models.mlp import init_mlp
    from fairify_tpu_torch.parallel.mesh import submesh
    from fairify_tpu_torch.verify import presets, sweep
    from fairify_tpu_torch.verify.config import EngineConfig

    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    eng = EngineConfig(pgd_phase=False, attack_samples=4, bab_attack_samples=4,
                       bab_frontier_cap=64, bab_rounds_per_segment=8, **phases,
                       **engine_kw)
    cfg = presets.get("GC").with_(
        result_dir=os.path.join(work, f"ladder-{device}-{len(engine_kw)}-{len(phases)}-"
                                      f"{mesh_parts}"),
        soft_timeout_s=20.0,
        hard_timeout_s=120.0, sim_size=16, exact_certify_masks=False, grid_chunk=8,
        domain_overrides=ov, partition_threshold=2, engine=eng)
    shutil.rmtree(cfg.result_dir, ignore_errors=True)
    net = init_mlp((len(cfg.query().columns), 4, 1), seed=3, device=device)
    rep = sweep.verify_model(net, cfg, model_name="BaB-1", resume=False,
                             device=device, partition_span=(0, 8),
                             mesh=submesh([device] * mesh_parts) if mesh_parts else None)
    with open(sweep.ledger_path(cfg, rep.sink_name)) as fp:
        rows = [json.loads(line) for line in fp if line.strip()]
    return rep, [(r["partition_id"], r["verdict"], r.get("engine_reason")) for r in rows], net, cfg


def tiny_oracle_case() -> int:
    """decide_many through K5/K6 on the oracle-sized toy worlds (4 dims,
    one binary PA): every decided verdict must be the brute-force oracle's
    and every SAT witness exact.  Returns the number of roots checked."""
    import numpy as np

    from fairify_tpu_torch.verify import engine, oracle
    from fairify_tpu_torch.verify.config import EngineConfig
    from fairify_tpu_torch.verify.property import FairnessQuery, encode

    names = ("a0", "a1", "a2", "p")
    ranges = {n: (0, 2) for n in names}
    ranges["p"] = (0, 1)
    q = FairnessQuery(domain=oracle.tiny_domain(ranges), protected=("p",))
    enc = encode(q)
    cfg = EngineConfig(**TAIL, alpha_iters=2, bab_frontier_cap=8, bab_rounds_per_segment=4)
    lo, hi = np.zeros(4, np.int64), np.array([2, 2, 2, 1], np.int64)
    for seed in range(6):
        net = oracle.random_net(np.random.default_rng(seed), (4, 8, 1), scale=0.6,
                                device="cuda")
        dec = engine.decide_many(net, enc, lo[None], hi[None], cfg, deadline_s=120.0)[0]
        want = oracle.brute_force_verdict(net, q, lo, hi)
        if dec.verdict != want:
            fail(f"tiny case seed {seed}: engine {dec.verdict}, oracle {want}")
        if dec.verdict == "sat" and not engine.validate_pair(*net.numpy_params(),
                                                             *dec.counterexample):
            fail(f"tiny case seed {seed}: witness fails its exact replay")
    return 6


# ---------------------------------------------------------------------------
# Phase 11: the runtime contracts — the launch pipeline on CUDA events, the
# sync check, the fault schedules, the trace / heartbeat / profiler, the
# sampled recheck
# ---------------------------------------------------------------------------

DEPTHS = (1, 2, 4)
DEPTH_CHUNK = 26  # GC-1's 201 partitions in 8 grid chunks
DEPTH_MEGA = 4  # 2 segments of 4 chunks
FAULT_SPECS = ("launch.decode:transient:1", "launch.submit:fatal:1",
               "launch.decode:corrupt:1", "ledger.append:corrupt:1")
RUN_COUNTERS = ("fault_injected", "launch_retries", "chunks_degraded", "integrity_violations",
                "integrity_rechecks", "ledger_crc_mismatch")
PHASE_KERNELS = {"stage0_prune": ("ka_kernel",), "stage0_decide": ("kb_kernel", "kc_kernel"),
                 "stage0_parity": ("kd_kernel",)}


def depth_cfg(work: str, gc_cfg, tag: str, **kw):
    """GC-1's configuration of phase 11: 8 grid chunks, 2 segments on the
    mega path."""
    return gc_cfg.with_(**dict(dict(result_dir=os.path.join(work, tag), grid_chunk=DEPTH_CHUNK,
                                    mega_chunks=DEPTH_MEGA), **kw))


def outcome_rows(rep) -> list:
    """(id, verdict, witness) of every partition of a report."""
    return [(o.partition_id, o.verdict,
             None if o.counterexample is None else [list(map(int, c))
                                                    for c in o.counterexample])
            for o in rep.outcomes]


def depth_gc(work: str, gc_net, gc_cfg, smi: str) -> dict:
    """11a, GC-1 end to end: the chunk loop and the mega path at every
    depth; rows, funnels, histograms and launches equal."""
    out = {}
    for path, mega in (("chunk", 0), ("mega", DEPTH_MEGA)):
        for depth in DEPTHS:
            cfg = depth_cfg(work, gc_cfg, f"depth-{path}-{depth}", mega_chunks=mega,
                            pipeline_depth=depth)
            rep, launch, wall = run_sweep(gc_net, cfg, "GC-1",
                                          label=f"GC-1 {path} loop depth {depth}")
            thr = check_outputs(rep, cfg, gc_net, "GC-1", launch)
            out[(path, depth)] = dict(rows=run_rows(cfg, rep), funnel=rep.funnel["states"],
                                      hist=rep.funnel["margin_hist"], launch=launch,
                                      wall=wall, thr=thr, counts=rep.counts)
    ref = out[("chunk", 1)]
    for (path, depth), r in out.items():
        if (r["rows"] != ref["rows"] or r["funnel"] != ref["funnel"]
                or r["hist"] != ref["hist"] or r["launch"] != out[(path, 1)]["launch"]):
            fail(f"pipeline depth {depth}, GC-1 {path}: rows, funnel, histograms or "
                 f"launches differ from depth 1 / the chunk loop ({r['counts']}, "
                 f"{r['launch']})")
        thr = r["thr"]
        print(f"[pipeline depth {depth}, GC-1 {path}] {r['counts']} in {r['wall']:.4f} s; "
              f"launches_in_flight max {thr['launches_in_flight_max']} mean "
              f"{thr['launches_in_flight_mean']}; stage0_decide "
              f"{thr['phases_s']['stage0_decide']} s, stage0_parity "
              f"{thr['phases_s']['stage0_parity']} s; launches {sum(r['launch'].values())}; "
              f"rows equal depth 1 and the chunk loop; {smi}", flush=True)
    return out


def depth_ac(ac_net, ac_cfg, smi: str) -> dict:
    """11a, the AC grid: stage 0 and parity through one pipeline at every
    depth, 8 chunks and 2 segments; verdicts, witnesses, parity and
    histograms equal; in-flight statistics and seconds per pass."""
    import numpy as np
    import torch

    from fairify_tpu_torch.obs import funnel as funnel_mod
    from fairify_tpu_torch.parallel.pipeline import LaunchPipeline
    from fairify_tpu_torch.verify import pruning, sweep
    from fairify_tpu_torch.verify.property import encode

    enc = encode(ac_cfg.query())
    _, lo, hi = sweep.build_partitions(ac_cfg)
    prune = pruning.sound_prune_grid(ac_net, lo, hi, ac_cfg.sim_size, ac_cfg.seed,
                                     chunk=ac_cfg.grid_chunk, mega_chunks=ac_cfg.mega_chunks)
    out = {}
    for path, cfg in (("chunk", ac_cfg.with_(mega_chunks=0)), ("mega", ac_cfg)):
        for depth in DEPTHS:
            pipe = LaunchPipeline(depth, supervisor=sweep._supervisor(cfg))
            st = funnel_mod.StageStats()

            def passes(cfg=cfg, pipe=pipe, st=st):
                t0 = time.perf_counter()
                s0 = sweep.stage0_certify_and_attack(ac_net, enc, lo, hi, cfg, st, {},
                                                     pipe=pipe)
                t1 = time.perf_counter()
                par = sweep.parity_pass(ac_net, prune, lo, hi, cfg, pipe=pipe)
                torch.cuda.synchronize()
                return s0, par, t1 - t0, time.perf_counter() - t1

            (s0, par, t_s0, t_par), launch, _ = counted(
                passes, f"AC grid stage 0 + parity, {path} depth {depth}")
            out[(path, depth)] = dict(s0=s0, par=par, hist=st.hist.copy(), launch=launch,
                                      t_s0=t_s0, t_par=t_par, flight=pipe.stats.summary())
    ref = out[("chunk", 1)]
    for (path, depth), r in out.items():
        if (not same_stage0(r["s0"], ref["s0"]) or not np.array_equal(r["par"], ref["par"])
                or not np.array_equal(r["hist"], ref["hist"])
                or r["launch"] != out[(path, 1)]["launch"]):
            fail(f"pipeline depth {depth}, AC grid {path}: stage 0, parity, histograms or "
                 f"launches differ ({r['launch']})")
        print(f"[pipeline depth {depth}, AC grid {path}] stage 0 {r['t_s0']:.4f} s, parity "
              f"{r['t_par']:.4f} s; launches_in_flight max {r['flight']['max']} mean "
              f"{r['flight']['mean']}; launches {sum(r['launch'].values())}; verdicts, "
              f"witnesses, parity and histograms equal depth 1 and the chunk loop; {smi}",
              flush=True)
    return out


def bab_submit_args(net, enc, lo, hi, Q: int = 64):
    """The host queue, root validity (on the card) and constants of one
    device-BaB group of ``Q // 4`` roots, as ``engine.device_bab_phase``
    builds them."""
    import numpy as np

    from fairify_tpu_torch.parallel.pipeline import stage
    from fairify_tpu_torch.verify import engine

    d, V, G = lo.shape[1], enc.n_assign, max(1, Q // 4)
    Qs = Q + 1
    q = [np.zeros((Qs, d), np.float32), np.zeros((Qs, d), np.float32),
         np.zeros(Qs, np.int32), np.zeros(Qs, bool), np.zeros(Qs, bool),
         np.zeros(Qs, np.int32), np.zeros(Qs, np.int32), np.zeros((Qs, d), np.float32)]
    g = min(G, lo.shape[0])
    q[0][:g], q[1][:g], q[2][:g], q[3][:g] = lo[:g], hi[:g], np.arange(g), True
    pa = np.asarray(enc.pa_idx)
    root_valid = np.zeros((G, V), bool)
    root_valid[:g] = ((enc.assignments[None] >= lo[:g, None, pa])
                      & (enc.assignments[None] <= hi[:g, None, pa])).all(-1)
    slot_ok = np.zeros(Qs, bool)
    slot_ok[:Q] = True
    bm = np.zeros(d, np.float32)
    bm[engine._branch_dims(enc, d)] = 1.0
    return q, stage(root_valid, net.device), engine.bab_consts(net, enc, d, slot_ok, bm)


def sync_check(gc_net, gc_cfg, smi: str) -> dict:
    """11b: one submit of every pipelined path, and the start of its fetch,
    under ``torch.cuda.set_sync_debug_mode("error")`` after a warm-up call
    of each; then the fetch."""
    import numpy as np
    import torch

    from dataclasses import replace

    from fairify_tpu_torch.parallel import mesh as mesh_mod
    from fairify_tpu_torch.parallel import pipeline
    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.verify import engine, pruning, sweep
    from fairify_tpu_torch.verify.property import encode

    cfg = gc_cfg.with_(grid_chunk=DEPTH_CHUNK, mega_chunks=DEPTH_MEGA)
    ibp = cfg.with_(engine=replace(cfg.engine, use_crown=False))
    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    step, segs = grid_mod.segment_spans(len(lo), cfg.grid_chunk, cfg.mega_chunks)
    n = cfg.grid_chunk
    mesh = mesh_mod.submesh(["cuda:0"] * 3)
    reps = mesh_mod.replicated(mesh, gc_net)
    stack = mesh_mod.stack_models([gc_net, gc_net])
    prune = pruning.sound_prune_grid(gc_net, lo, hi, cfg.sim_size, cfg.seed,
                                     chunk=cfg.grid_chunk, mega_chunks=0)
    q, root_valid, consts = bab_submit_args(gc_net, enc, lo, hi)
    submits = {
        "prune block": lambda: pruning.prune_block_submit(gc_net, lo[:n], hi[:n], cfg.sim_size,
                                                          cfg.seed, 0, n),
        "mega segment": lambda: sweep.mega_segment_submit(gc_net, enc, lo, hi, cfg,
                                                          segs[0][2], step, 0)[0],
        "fused chunk": lambda: sweep.stage0_block_submit(gc_net, enc, lo[:n], hi[:n], cfg, 7,
                                                         n)[0],
        "IBP chunk": lambda: sweep.stage0_block_submit(gc_net, enc, lo[:n], hi[:n], ibp, 7,
                                                       n)[0],
        "mesh chunk": lambda: sweep.stage0_block_submit(gc_net, enc, lo[:n], hi[:n], cfg, 7, n,
                                                        mesh=mesh, replicas=reps)[0],
        "family segment": lambda: sweep.mega_segment_submit(stack, enc, lo, hi, cfg,
                                                            segs[0][2], step, 0)[0],
        "parity block": lambda: sweep.parity_submit(gc_net, prune, lo, hi, cfg, 0, n, n),
        "PGD chunk": lambda: engine.pgd_attack_submit(
            gc_net, enc, lo[:16], hi[:16], np.random.default_rng(1),
            steps=cfg.engine.pgd_steps, restarts=cfg.engine.pgd_restarts)[0],
        "device-BaB segment": lambda: engine.bab_segment_submit(
            gc_net, q, root_valid, consts, cfg.engine.bab_rounds_per_segment, 8),
    }
    bad, times = {}, {}
    for name, fn in submits.items():
        pipeline.fetch(fn())  # warm: packs, constants, the first launch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            flight = pipeline.start_fetch(fn())
        except RuntimeError as exc:
            bad[name] = str(exc).splitlines()[0]
            flight = None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        times[name] = time.perf_counter() - t0
        if flight is not None:
            pipeline.finish_fetch(*flight)
    if bad:
        fail(f"sync check: implicit syncs in the submit half of {bad}")
    print(f"[sync check] {len(submits)} pipelined submits and their fetch starts under "
          f"set_sync_debug_mode('error'), no implicit sync; host seconds of each submit "
          f"{ {k: round(v, 5) for k, v in times.items()} }; {smi}", flush=True)
    return {"paths": list(submits), "submit_s": times}


def counter_totals() -> dict:
    from fairify_tpu_torch import obs

    return {n: obs.registry().counter(n).total() for n in RUN_COUNTERS}


def fault_schedules(work: str, gc_net, gc_cfg, smi: str) -> dict:
    """11c: GC-1 under each of FAULT_SPECS, then a resume; the fault-free
    rows from a run of the same configuration."""
    import numpy as np

    from fairify_tpu_torch.parallel.pipeline import fetch
    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.verify import sweep
    from fairify_tpu_torch.verify.property import encode

    base = depth_cfg(work, gc_cfg, "faults-free", launch_backoff_s=1e-3)
    want = outcome_rows(sweep.verify_model(gc_net, base, model_name="GC-1", resume=False))
    # A re-dispatched segment (a decode retry's relaunch) is bit-equal to
    # the first dispatch.
    enc = encode(base.query())
    _, lo, hi = sweep.build_partitions(base)
    step, segs = grid_mod.segment_spans(len(lo), base.grid_chunk, base.mega_chunks)
    first, again = (fetch(sweep.mega_segment_submit(gc_net, enc, lo, hi, base, segs[0][2],
                                                    step, 0)[0]) for _ in range(2))
    if any(not np.array_equal(first[k], again[k]) for k in first):
        fail("faults: a re-dispatched segment differs from its first dispatch")
    out = {}
    for spec in FAULT_SPECS:
        cfg = base.with_(result_dir=os.path.join(work, f"faults-{spec}"), inject_faults=(spec,))
        c0 = counter_totals()
        t0 = time.perf_counter()
        rep = sweep.verify_model(gc_net, cfg, model_name="GC-1", resume=False)
        wall = time.perf_counter() - t0
        c1 = counter_totals()
        resumed = sweep.verify_model(gc_net, cfg.with_(inject_faults=()), model_name="GC-1",
                                     resume=True)
        c2 = counter_totals()
        run = {k: c1[k] - c0[k] for k in c0}
        reload = {k: c2[k] - c1[k] for k in c0}
        got = outcome_rows(rep)
        ok = outcome_rows(resumed) == want and resumed.degraded == 0 and run["fault_injected"]
        kind = spec.split(":")[1]
        if spec.startswith("launch.decode:transient"):
            ok = ok and got == want and rep.degraded == 0 and run["launch_retries"] == 1
        elif kind == "fatal":
            ok = ok and rep.degraded > 0
        elif spec.startswith("launch.decode:corrupt"):
            ok = ok and rep.degraded > 0 and run["integrity_violations"] >= 1
        else:  # the ledger row mutates after its CRC: caught on reload
            ok = ok and got == want and reload["ledger_crc_mismatch"] >= 1
        if not ok:
            fail(f"faults {spec}: degraded {rep.degraded}, counters {run}, on resume "
                 f"{reload}, resume equals the fault-free rows "
                 f"{outcome_rows(resumed) == want}")
        out[spec] = dict(degraded=rep.degraded, counters=run, resume_counters=reload,
                         wall_s=wall)
        print(f"[faults {spec}] GC-1 in {wall:.4f} s: degraded {rep.degraded}, counters "
              f"{ {k: v for k, v in run.items() if v} }, on resume "
              f"{ {k: v for k, v in reload.items() if v} }; the resume gives the "
              f"fault-free rows; {smi}", flush=True)
    return out


def trace_and_profiler(work: str, gc_net, gc_cfg, smi: str) -> dict:
    """11d: GC-1 with ``trace_out``, ``heartbeat_s`` and ``profile_dir``."""
    import collections
    import glob

    from fairify_tpu_torch import obs
    from fairify_tpu_torch.verify import sweep

    trace = os.path.join(work, "trace", "run.jsonl")
    prof = os.path.join(work, "trace", "prof")
    cfg = depth_cfg(work, gc_cfg, "trace", trace_out=trace, heartbeat_s=0.5, profile_dir=prof)
    t0 = time.perf_counter()
    rep = sweep.verify_model(gc_net, cfg, model_name="GC-1", resume=False)
    wall = time.perf_counter() - t0
    recs, skipped = obs.load_events(trace, count_skipped=True)
    spans = collections.Counter(r["name"] for r in recs if r["type"] == "span")
    verdicts = [r for r in recs if r["type"] == "event" and r["name"] == "verdict"]
    need = ("verify_model", "stage0_prune", "prune.sim_and_bounds", "stage0_decide",
            "stage0_parity", "pipeline.drain")
    if skipped or any(spans[k] == 0 for k in need) or len(verdicts) != rep.partitions_total:
        fail(f"trace: skipped {skipped}, spans {dict(spans)}, verdict events {len(verdicts)}")
    (path,) = glob.glob(os.path.join(prof, "trace-*.json"))
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    under = {}
    ranges = {ph: [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("name") == ph and e.get("cat") in ("user_annotation",
                                                               "gpu_user_annotation")]
              for ph in PHASE_KERNELS}
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    for ph, names in PHASE_KERNELS.items():
        for name in names:
            hits = 0
            for k in kernels:
                if name not in k.get("name", ""):
                    continue
                ts = launch_ts.get(k.get("args", {}).get("correlation"), k["ts"])
                hits += any(a <= ts <= b for a, b in ranges[ph])
            under[f"{name} under {ph}"] = hits
    if any(v == 0 for v in under.values()):
        fail(f"profiler: kernels under the phase annotations {under}; annotations "
             f"{ {k: len(v) for k, v in ranges.items()} }, {len(kernels)} kernel events")
    print(f"[trace and profiler] GC-1 in {wall:.4f} s with trace_out, heartbeat_s and "
          f"profile_dir: {sum(spans.values())} spans ({dict(spans)}), "
          f"{len(verdicts)} verdict events; profiler trace {os.path.getsize(path)} bytes, "
          f"{len(kernels)} kernel events, {under}; {smi}", flush=True)
    return {"spans": dict(spans), "kernels_under_phases": under, "wall_s": wall}


def sampled_recheck(work: str, gc_net, gc_cfg, smi: str) -> dict:
    """11e: GC-1 at ``integrity_recheck=1.0``."""
    from fairify_tpu_torch import obs
    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.verify import exact_check, sweep
    from fairify_tpu_torch.verify.property import encode

    cfg = depth_cfg(work, gc_cfg, "recheck", integrity_recheck=1.0)
    rc = obs.registry().counter("integrity_rechecks")
    before = {s["labels"]["kind"]: s["value"] for s in rc.snapshot()}
    c0 = counter_totals()
    t0 = time.perf_counter()
    rep = sweep.verify_model(gc_net, cfg, model_name="GC-1", resume=False)
    wall = time.perf_counter() - t0
    c1 = counter_totals()
    kinds = {s["labels"]["kind"]: s["value"] - before.get(s["labels"]["kind"], 0)
             for s in rc.snapshot()}
    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    _, spans = grid_mod.chunk_spans(len(lo), cfg.grid_chunk)
    unsat = {o.partition_id - 1 for o in rep.outcomes if o.verdict == "unsat"}
    weights, biases = gc_net.numpy_params()
    tally = {}
    for s, e in spans:
        first = next((p for p in range(s, e) if p in unsat), None)
        if first is not None:
            v = exact_check.decide_pair_box_exact(weights, biases, enc, lo[first], hi[first],
                                                  max_nodes=2000)["verdict"]
            tally[v] = tally.get(v, 0) + 1
    violations = c1["integrity_violations"] - c0["integrity_violations"]
    if (kinds.get("chunk") != len(spans) or violations or rep.degraded or "refuted" in tally
            or kinds.get("exact", 0) != sum(tally.values())):
        fail(f"sampled recheck: rechecks {kinds}, violations {violations}, degraded "
             f"{rep.degraded}, exact oracle {tally}")
    print(f"[sampled recheck] GC-1 at integrity_recheck=1.0 in {wall:.4f} s: {rep.counts}; "
          f"rechecks {kinds} of {len(spans)} chunks, 0 violations; the exact oracle on each "
          f"chunk's first certified partition {tally}; {smi}", flush=True)
    return {"rechecks": kinds, "exact": tally, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 12: the SMT tier and run_sweep
# ---------------------------------------------------------------------------

# The German Credit file's codes (UCI ``german.data``, 21 space-separated
# fields): per column, the codes or the integer range a synthetic row draws.
GERMAN_CODES = (
    ("A11", "A12", "A13", "A14"), (4, 72), ("A30", "A31", "A32", "A33", "A34"),
    ("A40", "A41", "A42", "A43", "A44", "A45", "A46", "A48", "A49", "A410"), (250, 18424),
    ("A61", "A62", "A63", "A64", "A65"), ("A71", "A72", "A73", "A74", "A75"), (1, 4),
    ("A91", "A92", "A93", "A94", "A95"), ("A101", "A102", "A103"), (1, 4),
    ("A121", "A122", "A123", "A124"), (19, 75), ("A141", "A142", "A143"),
    ("A151", "A152", "A153"), (1, 4), ("A171", "A172", "A173", "A174"), (1, 2),
    ("A191", "A192"), ("A201", "A202"), (1, 2))


def write_german(path: str, rows: int, seed: int) -> None:
    """A synthetic ``german/german.data`` of ``rows`` rows in the loader's
    format (the UCI file's codes and ranges, drawn from ``default_rng(seed)``;
    the real file has 1,000 rows)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fp:
        for _ in range(rows):
            fields = [str(c[rng.integers(len(c))]) if isinstance(c[0], str)
                      else str(int(rng.integers(c[0], c[1] + 1))) for c in GERMAN_CODES]
            fp.write(" ".join(fields) + "\n")


# Phase 12a's world: tests/test_torch_bab.py's 20-4-1 net (seed 3) on the GC
# preset with the domain shrunk to boxes of 8-16 integer pairs, which the
# brute backend enumerates (the GC-1 twin's stage 0 and BaB decide every
# such box and leave the tier nothing).  A hung dispatch waits the first
# tier (SMT_SOFT_S) plus the pool's grace before its SIGKILL.
SMT_NET_SEED = 3
SMT_SOFT_S = 2.0
SMT_RETRY_S = (10.0,)
SMT_WORKERS, SMT_CAP_MB = 2, 2048
SMT_MIN_QUERIES = 8
SMT_FAULTS = ("smt.worker.crash:transient:1", "smt.worker.hang:transient:1",
              "smt.worker.memout:transient:1")
# The fault runs' worker cap: a memout directive's allocation reaches it
# well inside the first tier's deadline (at 2,048 MB it may not).
SMT_FAULT_CAP_MB = 256
SMT_SPAWNS = 8
# 12a's SAT world: tests/test_torch_smt.py's net, stage 0, PGD, BaB and the
# retry stubbed to decide nothing, a pool whose pair cap concedes the
# 16-pair boxes: the tier decides sat, unsat and unknown roots.
SMT_SAT_SEED, SMT_SAT_CAP = 2, 8
# 12b's world: the GC-1 twin and a second 20-50-1 twin (a family of two)
# over the whole GC grid, with a synthetic German file of the real file's
# 1,000 rows.
FAMILY12_SEEDS = (0, 1)
GERMAN_ROWS, GERMAN_SEED = 1000, 16
CARD = "cuda"  # phase 12's device (a rehearsal on the CPU sets "cpu")
TIME_COLS = ("SV-time", "S-time", "HV-Time", "H-Time", "Total-Time")


def smt_cfg(work: str, tag: str, **kw):
    """Phase 12a's configuration (``tag`` names its result directory)."""
    from fairify_tpu_torch.data.domains import get_domain
    from fairify_tpu_torch.verify import presets
    from fairify_tpu_torch.verify.config import EngineConfig

    ov = {c: (0, 0) for c in get_domain("german").columns}
    ov.update(age=(0, 1), month=(0, 5), purpose=(0, 5), credit_amount=(0, 2))
    d = os.path.join(work, "smt", tag)
    return presets.get("GC").with_(**dict(dict(
        result_dir=d, trace_out=os.path.join(d, "trace.jsonl"), exact_certify_masks=False,
        sim_size=16, grid_chunk=8, domain_overrides=ov, partition_threshold=2,
        soft_timeout_s=SMT_SOFT_S, hard_timeout_s=600.0, smt_retry_timeouts_s=SMT_RETRY_S,
        smt_workers=SMT_WORKERS, smt_memory_cap_mb=SMT_CAP_MB, launch_backoff_s=1e-3,
        engine=EngineConfig(attack_samples=4, bab_frontier_cap=64, max_nodes=1, **TAIL)),
        **kw))


def smt_pool_for(cfg, **kw):
    """A pool configured as the sweep's own tier would be (shared runs)."""
    from fairify_tpu_torch.smt import pool as pool_mod

    return pool_mod.SmtPool(pool_mod.PoolConfig(**dict(dict(
        workers=SMT_WORKERS, memory_cap_mb=SMT_CAP_MB, seed=cfg.seed,
        max_retries=cfg.max_launch_retries, backoff_s=cfg.launch_backoff_s), **kw)))


def smt_sat_net(device: str):
    import numpy as np

    from fairify_tpu_torch.models.mlp import from_numpy

    rng = np.random.default_rng(SMT_SAT_SEED)
    ws = [rng.normal(scale=0.5, size=s).astype(np.float32) for s in ((20, 4), (4, 1))]
    bs = [rng.normal(scale=0.5, size=s).astype(np.float32) for s in ((4,), (1,))]
    return from_numpy(ws, bs, device=device)


class DecideNothing:
    """Stage 0, the PGD pass, the engine and the heuristic retry decide
    nothing while this is open: every root reaches the SMT tier (12a's SAT
    world; the same stubs as tests/test_torch_smt.py)."""

    def __enter__(self):
        import numpy as np

        from fairify_tpu_torch.verify import engine, sweep

        def nothing(net, enc, lo, hi, cfg, *a, **kw):
            return np.zeros(lo.shape[0], bool), np.zeros(lo.shape[0], bool), {}

        self.saved = [(sweep, "stage0_certify_and_attack"), (sweep, "stage0_pgd"),
                      (engine, "decide_many"), (engine, "decide_box")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        sweep.stage0_certify_and_attack = nothing
        sweep.stage0_pgd = lambda *a, **kw: ({}, True)
        engine.decide_many = lambda net, enc, lo, hi, cfg, **kw: [
            engine.Decision("unknown", reason="deadline") for _ in range(lo.shape[0])]
        engine.decide_box = lambda *a, **kw: engine.Decision("unknown")
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def sink_rows(cfg, rep, csvs=("",)) -> dict:
    """A run's ledger rows (less time and CRC) and its CSVs' rows (less the
    time columns): ``csvs`` the suffixes after the sink name (``""`` the
    24-column CSV, ``"-metrics"`` the group-metrics CSV)."""
    import csv

    from fairify_tpu_torch.verify import sweep

    with open(sweep.ledger_path(cfg, rep.sink_name)) as fp:
        out = {"ledger": [{k: v for k, v in json.loads(line).items()
                           if k not in ("time_s", "_crc")} for line in fp if line.strip()]}
    for suffix in csvs:
        with open(os.path.join(cfg.result_dir, f"{rep.sink_name}{suffix}.csv"),
                  newline="") as fp:
            rows = list(csv.reader(fp))
        keep = [i for i, c in enumerate(rows[0]) if c not in TIME_COLS]
        out["csv" + suffix] = [[r[i] for i in keep] for r in rows]
    return out


def smt_rows(cfg, rep) -> dict:
    """One 12a run's comparable outputs: the verdict map, ledger and CSV rows
    (:func:`sink_rows`), and per partition the verdict event's ``via``,
    ``smt_reason`` and ``failure``."""
    with open(cfg.trace_out) as fp:
        events = [json.loads(line) for line in fp if line.strip()]
    why = {str(e["attrs"]["partition_id"]): [e["attrs"]["via"], e["attrs"].get("smt_reason"),
                                             e["attrs"].get("failure")]
           for e in events if e.get("type") == "event" and e.get("name") == "verdict"}
    return dict(sink_rows(cfg, rep), why=why,
                map={str(o.partition_id): o.verdict for o in rep.outcomes})


def smt_counters() -> dict:
    from fairify_tpu_torch import obs

    reg = obs.registry()
    return {"crash": reg.counter("smt_worker_crashes").value(kind="crash"),
            "hang": reg.counter("smt_worker_crashes").value(kind="hang"),
            "memout": reg.counter("smt_memouts").total(),
            "queries": reg.counter("smt_queries").total()}


def smt_runs(work: str, device: str, pool=None) -> dict:
    """12a's runs both sides make: the blocking run (``integrity_recheck``
    1.0; ``pool`` shared when given), one run per fault schedule (the run's
    own pool) and the SAT world; rows and SMT counters of each."""
    from fairify_tpu_torch import obs
    from fairify_tpu_torch.models.mlp import init_mlp
    from fairify_tpu_torch.verify import sweep

    out = {}
    net = init_mlp((20, 4, 1), seed=SMT_NET_SEED, device=device)
    runs = [("block", dict(integrity_recheck=1.0), pool)]
    runs += [(spec, dict(inject_faults=(spec,), smt_memory_cap_mb=SMT_FAULT_CAP_MB), None)
             for spec in SMT_FAULTS]
    for tag, kw, shared in runs:
        cfg = smt_cfg(work, tag.replace(":", "_"), **kw)
        obs.registry().reset()
        t = time.perf_counter()
        rep = sweep.verify_model(net, cfg, model_name="smt", resume=False, device=device,
                                 smt_pool=shared)
        out[tag] = dict(smt_rows(cfg, rep), counters=smt_counters(),
                        seconds=time.perf_counter() - t)
    cfg = smt_cfg(work, "sat")
    obs.registry().reset()
    with DecideNothing(), smt_pool_for(cfg, backend="brute", pair_cap=SMT_SAT_CAP) as sat_pool:
        rep = sweep.verify_model(smt_sat_net(device), cfg, model_name="sat", resume=False,
                                 device=device, smt_pool=sat_pool)
    out["sat"] = dict(smt_rows(cfg, rep), counters=smt_counters())
    return out


def family12_files(work: str) -> tuple:
    """12b's model root (the two twins' .npz exports) and data root (the
    synthetic German file), written from their seeds."""
    import numpy as np

    from fairify_tpu_torch.models import ingest

    models, data = os.path.join(work, "p12-models"), os.path.join(work, "p12-data")
    os.makedirs(os.path.join(models, "german"), exist_ok=True)
    for k, seed in enumerate(FAMILY12_SEEDS):
        rng = np.random.default_rng(seed)  # the GC-1 twin's draws (flagship_net)
        ws = [rng.normal(scale=0.3, size=s).astype(np.float32) for s in ((20, 50), (50, 1))]
        bs = [rng.normal(scale=0.1, size=s).astype(np.float32) for s in ((50,), (1,))]
        ingest.save_npz((ws, bs), os.path.join(models, "german", f"GC-{k + 1}.npz"))
    write_german(os.path.join(data, "german", "german.data"), GERMAN_ROWS, GERMAN_SEED)
    return models, data


def family12_cfg(work: str, tag: str):
    from fairify_tpu_torch.verify import presets

    return presets.get("GC").with_(result_dir=os.path.join(work, "p12", tag),
                                   soft_timeout_s=10.0, hard_timeout_s=600.0,
                                   exact_certify_masks=False, partition_metrics=True,
                                   engine=smoke_engine_cfg())


def family12_rows(cfg, rep) -> dict:
    """One 12b report's comparable outputs: counts, original accuracy, rows
    and witnesses, and :func:`sink_rows`' ledger, CSV and metrics CSV."""
    return dict(sink_rows(cfg, rep, ("", "-metrics")), model=rep.model, counts=rep.counts,
                original_acc=rep.original_acc,
                rows=[[o.partition_id, o.verdict, None if o.counterexample is None
                       else [c.tolist() for c in o.counterexample]] for o in rep.outcomes])


def family12_runs(work: str, device: str):
    """12b's run both sides make: ``run_sweep`` over the family, the
    dataset and ``partition_metrics``.  Returns ``(reports, rows)``."""
    from fairify_tpu_torch.verify import sweep

    models, data = family12_files(work)
    cfg = family12_cfg(work, "whole")
    reps = sweep.run_sweep(cfg, model_root=models, data_root=data, device=device)
    return reps, [family12_rows(cfg, r) for r in reps]


def phase12_cpu(work: str) -> dict:
    """Phase 12's CPU side (in the CPU worker): 12a's runs and 12b's
    ``run_sweep`` on the plain path."""
    t = time.perf_counter()
    out = {"smt": smt_runs(work, "cpu")}
    out["smt_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["family"] = family12_runs(work, "cpu")[1]
    out["family_s"] = time.perf_counter() - t
    return out


def cuda_maps(pid: int) -> list:
    """The CUDA and torch libraries a process maps (none for an SMT worker)."""
    with open(f"/proc/{pid}/maps") as fp:
        return sorted({line.split()[-1] for line in fp
                       if "libcuda" in line or "libtorch" in line})


def smt_spawns() -> list:
    """SMT_SPAWNS fresh workers, one after another, from this process (CUDA
    live): each one's seconds to its hello, and the backends they report
    (``auto``: z3 where it is installed, else brute); fails if one maps a
    CUDA or torch library."""
    from fairify_tpu_torch.smt import pool as pool_mod

    cfg = pool_mod.PoolConfig(workers=1, memory_cap_mb=SMT_CAP_MB)
    times, backends = [], set()
    for _ in range(SMT_SPAWNS):
        t = time.perf_counter()
        w = pool_mod._Worker(cfg, SMT_CAP_MB)
        times.append(time.perf_counter() - t)
        backends.add(w.backend)
        try:
            bad = cuda_maps(w.proc.pid)
        finally:
            w.kill()
        if bad:
            fail(f"an SMT worker maps {bad}")
    return times, sorted(backends)


def z3_checks(work: str, net, rows: dict, srep, snet) -> str:
    """Where ``z3-solver`` is installed (the pool's ``auto`` backend is then
    z3): the in-process ``decide_box_smt`` gives the pool's verdict on every
    root the tier decided in 12a's world, and the SAT world through a z3
    pool (no pair cap) decides every root, its SAT witnesses replay on the
    net, and it agrees with the brute backend wherever that decided."""
    import numpy as np

    from fairify_tpu_torch.verify import engine, smt, sweep
    from fairify_tpu_torch.verify.property import encode

    if not smt.HAVE_Z3:
        return "z3 absent"
    cfg = smt_cfg(work, "block")
    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    roots = [int(p) for p, (via, _r, _f) in rows["why"].items() if via == "smt"]
    inproc = {p: smt.decide_box_smt(net, enc, lo[p - 1], hi[p - 1], soft_timeout_s=10.0)[0]
              for p in roots}
    if any(v != rows["map"][str(p)] for p, v in inproc.items()):
        fail(f"decide_box_smt {inproc} against the pool's {rows['map']}")
    zcfg = smt_cfg(work, "sat-z3")
    with DecideNothing(), smt_pool_for(zcfg, backend="z3") as pool:
        zrep = sweep.verify_model(snet, zcfg, model_name="sat", resume=False, device=CARD,
                                  smt_pool=pool)
    w, b = snet.numpy_params()
    brute = {o.partition_id: o.verdict for o in srep.outcomes}
    bad = [o.partition_id for o in zrep.outcomes
           if o.verdict == "unknown" or (brute[o.partition_id] != "unknown"
                                         and o.verdict != brute[o.partition_id])
           or (o.verdict == "sat" and not engine.validate_pair(
               w, b, *(np.asarray(c, np.int64) for c in o.counterexample)))]
    if bad:
        fail(f"SAT world through z3: partitions {bad} ({zrep.counts})")
    return (f"z3: decide_box_smt = the pool on {len(roots)} roots; the SAT world through z3 "
            f"{zrep.counts}, witnesses replayed, = brute where it decided")


def smt_tier_phase(work: str, smi: str, cpu: dict) -> dict:
    """Phase 12a: the SMT tier on the card (see the module docstring)."""
    import numpy as np

    from fairify_tpu_torch import obs
    from fairify_tpu_torch.models.mlp import init_mlp
    from fairify_tpu_torch.verify import engine, exact_check, sweep
    from fairify_tpu_torch.verify.property import encode

    t0 = time.perf_counter()
    spawn, backends = smt_spawns()
    cfg = smt_cfg(work, "block", integrity_recheck=1.0)
    net = init_mlp((20, 4, 1), seed=SMT_NET_SEED, device=CARD)
    with smt_pool_for(cfg) as pool:
        obs.registry().reset()
        rep, launch, wall = counted(lambda: sweep.verify_model(
            net, cfg, model_name="smt", resume=False, device=CARD, smt_pool=pool),
            "SMT tier")
        rows, counters = smt_rows(cfg, rep), smt_counters()
        rechecks = obs.registry().counter("integrity_rechecks").value(kind="smt")
        violations = obs.registry().counter("integrity_violations").total()
        live = pool.live_workers()
        mapped = {p.pid: cuda_maps(p.pid) for p in live}
        # smt_defer through the same pool, its first dispatch hung past the
        # first tier: that root is deferred, and the drain converges to the
        # blocking map.
        dcfg = smt_cfg(work, "defer", inject_faults=("smt.worker.hang:transient:1",))
        drep = sweep.verify_model(net, dcfg, model_name="smt", resume=False, device=CARD,
                                  smt_pool=pool, smt_defer=True)
        pending = 0 if drep.smt_pending is None else drep.smt_pending.pending
        if pending == 0:
            fail("SMT tier: the smt_defer run deferred no root")
        drep.smt_pending.drain()
    thr = check_outputs(rep, cfg, net, "SMT tier", launch)
    want = cpu["block"]
    if {k: want[k] for k in rows} != rows:
        bad = [k for k in rows if rows[k] != want[k]]
        fail(f"SMT tier: card and CPU differ in {bad}")
    if counters["queries"] < SMT_MIN_QUERIES or counters["queries"] != want["counters"]["queries"]:
        fail(f"SMT tier: {counters['queries']} queries (CPU {want['counters']['queries']}, "
             f"at least {SMT_MIN_QUERIES} asked)")
    if any(mapped.values()) or not live:
        fail(f"SMT tier: live workers {[p.pid for p in live]} map {mapped}")
    missing = [k for k in SLICE2 if launch[k] == 0]
    if missing:
        fail(f"SMT tier: kernels never launched: {missing} ({launch})")
    # Every SMT UNSAT: the sampled recheck (rate 1.0) ran on it, and the
    # exact oracle confirms it here.
    enc = encode(cfg.query())
    _, lo, hi = sweep.build_partitions(cfg)
    w, b = net.numpy_params()
    smt_unsat = [int(p) for p, (via, _r, _f) in rows["why"].items()
                 if via == "smt" and rows["map"][p] == "unsat"]
    verdicts = {exact_check.decide_pair_box_exact(w, b, enc, lo[p - 1], hi[p - 1],
                                                  max_nodes=2000)["verdict"]
                for p in smt_unsat}
    if rechecks != len(smt_unsat) or violations or verdicts - {"unsat_confirmed"}:
        fail(f"SMT tier: {len(smt_unsat)} SMT UNSATs, {rechecks} rechecked, {violations} "
             f"violations, oracle {verdicts}")
    if {o.partition_id: o.verdict for o in drep.outcomes} != \
            {o.partition_id: o.verdict for o in rep.outcomes}:
        fail("SMT tier: the smt_defer run's drain did not converge to the blocking run")
    # One schedule per fault site: as on the CPU (rows and worker counters).
    faults = {}
    for spec in SMT_FAULTS:
        fcfg = smt_cfg(work, spec.replace(":", "_"), inject_faults=(spec,),
                       smt_memory_cap_mb=SMT_FAULT_CAP_MB)
        obs.registry().reset()
        frep = sweep.verify_model(net, fcfg, model_name="smt", resume=False, device=CARD)
        got = dict(smt_rows(fcfg, frep), counters=smt_counters())
        ref = cpu[spec]
        if any(got[k] != ref[k] for k in ("map", "ledger", "csv", "why", "counters")):
            fail(f"SMT tier under {spec}: card {got['counters']} vs CPU {ref['counters']}, "
                 f"maps equal {got['map'] == ref['map']}")
        faults[spec] = got["counters"]
    # The SAT world: SAT witnesses from out of process replay on the card's
    # net; rows equal the CPU's.
    scfg = smt_cfg(work, "sat")
    obs.registry().reset()
    snet = smt_sat_net(CARD)
    with DecideNothing(), smt_pool_for(scfg, backend="brute",
                                       pair_cap=SMT_SAT_CAP) as sat_pool:
        srep = sweep.verify_model(snet, scfg, model_name="sat", resume=False, device=CARD,
                                  smt_pool=sat_pool)
    sgot = smt_rows(scfg, srep)
    sw, sb = snet.numpy_params()
    sats = [o for o in srep.outcomes if o.verdict == "sat"]
    differ = [k for k in ("map", "ledger", "csv", "why") if sgot[k] != cpu["sat"][k]]
    if differ or not sats or not all(
            engine.validate_pair(sw, sb, *(np.asarray(c, np.int64) for c in o.counterexample))
            for o in sats):
        fail(f"SMT SAT world: card and CPU differ in {differ}: card {sgot['map']} / "
             f"{sgot['why']} vs CPU {cpu['sat']['map']} / {cpu['sat']['why']}")
    z3_note = z3_checks(work, net, rows, srep, snet)
    counts = rep.counts
    print(f"[SMT tier] {counters['queries']} SMT queries of {rep.partitions_total} "
          f"partitions (tests/test_torch_bab.py's 20-4-1 world; the GC-1 twin leaves the "
          f"tier no root): {counts}, card = CPU (map, ledger, CSV, smt_reason); "
          f"{len(smt_unsat)} SMT UNSATs rechecked and confirmed by the exact oracle; "
          f"smt_defer ({pending} deferred) drained to the blocking map; faults {faults}; "
          f"SAT world {srep.counts} ({len(sats)} witnesses replayed); {z3_note}; worker "
          f"spawn median "
          f"{np.median(spawn):.3f} s, max {max(spawn):.3f} s over {len(spawn)} (backend "
          f"{backends}), no "
          f"libcuda/libtorch mapped; fan-out {thr['phases_s'].get('smt_fanout', 0.0):.3f} s "
          f"of a {wall:.3f} s run; phases {thr['phases_s']}; launches {launch}; "
          f"12a in {time.perf_counter() - t0:.3f} s; {smi}", flush=True)
    return {"queries": counters["queries"], "counts": counts, "spawn_s": spawn,
            "fanout_s": thr["phases_s"].get("smt_fanout", 0.0), "wall_s": wall,
            "launch": launch, "seconds": time.perf_counter() - t0}


def family12_phase(work: str, smi: str, cpu: list) -> dict:
    """Phase 12b: ``run_sweep`` on the card (see the module docstring)."""
    import numpy as np

    from fairify_tpu_torch.data import loaders
    import csv

    from fairify_tpu_torch.models.ingest import load_npz, npz_arrays
    from fairify_tpu_torch.models.mlp import forward_np
    from fairify_tpu_torch.verify import sweep

    t0 = time.perf_counter()
    (reps, rows), launch, wall = counted(lambda: family12_runs(work, CARD), "run_sweep GC")
    models, data = family12_files(work)
    cfg = family12_cfg(work, "whole")
    ds = loaders.load("german", root=data)
    for rep, got, want in zip(reps, rows, cpu):
        path = os.path.join(models, "german", f"{rep.model}.npz")
        check_outputs(rep, cfg, load_npz(path, device=CARD), rep.model, rep.kernel_launches)
        w, b, _, _ = npz_arrays(path)
        excused = np.flatnonzero(np.abs(forward_np(w, b, ds.X_test)) < 1e-5)
        acc_ok = abs(got["original_acc"] - want["original_acc"]) <= len(excused) / len(ds.y_test)
        gm, wm = (np.array([[float(v) for v in r] for r in x["csv-metrics"][1:]])
                  for x in (got, want))
        metrics_ok = gm.shape == wm.shape and np.allclose(
            gm, wm, rtol=0.0, atol=1e-6 + len(excused) / len(ds.y_test), equal_nan=True)
        same = all(got[k] == want[k] for k in ("model", "counts", "rows", "ledger", "csv"))
        if not (same and acc_ok and metrics_ok
                and got["csv-metrics"][0] == want["csv-metrics"][0]):
            fail(f"run_sweep {rep.model}: card and CPU differ (rows {same}, original_acc "
                 f"{got['original_acc']} vs {want['original_acc']}, metrics {metrics_ok})")
        if any(rep.kernel_launches.get(k, 0) for k in ("stage0_certify", "attack_flips")):
            fail(f"run_sweep {rep.model}: its own stage-0 launches {rep.kernel_launches}")
    # The family's stage 0: KB and KC as rows 5 and 7 (M = 2), the models'
    # verify_model runs took it as stage0= and launched neither.
    fam = {k: launch[k] - sum(r.kernel_launches.get(k, 0) for r in reps)
           for k in ("stage0_certify", "attack_flips")}
    if min(fam.values()) < 1 or len(reps) != len(FAMILY12_SEEDS):
        fail(f"run_sweep: family launches {fam} of {launch}, {len(reps)} reports")
    # Two host slices: their ledgers' union is the whole run's verdicts.
    union = {r.model: {} for r in reps}
    for i in range(2):
        hcfg = family12_cfg(work, f"host{i}")
        for rep in sweep.run_sweep(hcfg, model_root=models, data_root=data, host_index=i,
                                   host_count=2, device=CARD):
            with open(sweep.ledger_path(hcfg, rep.sink_name)) as fp:
                union[rep.model].update({r["partition_id"]: r["verdict"]
                                         for r in map(json.loads, fp)})
    if union != {r.model: {o.partition_id: o.verdict for o in r.outcomes} for r in reps}:
        fail("run_sweep: the two host slices' ledgers do not make the whole run")
    # retry_unknown on the finished run: one CSV and metrics row per partition.
    retry = sweep.run_sweep(cfg, model_root=models, data_root=data, retry_unknown=True,
                            device=CARD)
    for rep in retry:
        for name in (f"{rep.sink_name}.csv", f"{rep.sink_name}-metrics.csv"):
            with open(os.path.join(cfg.result_dir, name), newline="") as fp:
                ids = [int(r[0]) for r in list(csv.reader(fp))[1:]]
            if ids != list(range(1, rep.partitions_total + 1)):
                fail(f"run_sweep retry_unknown: {name} has {len(ids)} rows")
    try:
        sweep.run_sweep(cfg, model_root=models, data_root=data, n_shards=2, device=CARD)
        fail("run_sweep: n_shards=2 ran")
    except NotImplementedError as exc:
        if "item 7" not in str(exc):
            fail(f"run_sweep: n_shards=2 raised {exc!r}")
    decided = sum(r.counts["sat"] + r.counts["unsat"] for r in reps)
    print(f"[run_sweep] GC grid x {len(reps)} twins (family of two, synthetic German file "
          f"of {GERMAN_ROWS} rows, partition_metrics): {[r.counts for r in reps]}, original "
          f"accuracy {[round(r.original_acc, 6) for r in reps]}, card = CPU (rows, ledgers, "
          f"CSVs, metrics to 1e-6); {decided} decided in {wall:.3f} s = "
          f"{decided / wall:.2f} partitions/s; family launches (rows 5, 7) {fam}; launches "
          f"{launch}; host slices 2 = the whole run; retry_unknown one row per partition; "
          f"n_shards raises (item 7); 12b in {time.perf_counter() - t0:.3f} s; {smi}",
          flush=True)
    return {"launch": launch, "family": fam, "wall_s": wall, "decided": decided,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 13: the experiment path (verify -> localize -> repair -> re-verify ->
# hybrid audit) and its training kernels, rows 25-28
# ---------------------------------------------------------------------------

# Phase 13's dataset: the real Adult file is not in the repository, so rows
# are drawn from the AC preset's adult domain, labelled by trained AC-S1
# with EXP_FLIP of the labels flipped, all from default_rng(EXP_SEED).
EXP_TRAIN, EXP_TEST, EXP_FLIP, EXP_SEED = 30_000, 5_000, 0.1, 17
# run_experiment's grid: the AC preset capped at max_partitions (the
# experiment command's --max-partitions: 288 partitions of the adult
# domain), the slice-2 tail with a node cap, under a hard budget.
EXP_MAX_PARTITIONS, EXP_HARD_S, EXP_MAX_NODES = 512, 300.0, 200
# Rows 25-28 against their plain versions on the card.  One step from one
# state: theta, m and v within STEP_REL * |v| + STEP_ABS * max |v| (the two
# sum a batch's products in other orders; Adam is the same f32 operations
# in both), the loss within STEP_REL; over 100 steps from one state the
# losses within RUN_REL (the per-step differences carry along).
STEP_REL, STEP_ABS, RUN_REL = 1e-5, 1e-6, 1e-4
# Card vs CPU worker over whole trainings (thousands of steps, each summed
# in another order): weights within EXP_W_REL * |w| + EXP_W_ABS, history
# losses and inconsistencies within EXP_H_REL, val_acc within EXP_ACC_ABS
# (10 of the 5,000 test rows).
EXP_W_REL, EXP_W_ABS, EXP_H_REL, EXP_ACC_ABS = 1e-3, 1e-4, 1e-3, 2e-3
# 13b: train_mlp at AC-S1's widths, 3 epochs at B = 128; the final test-set
# predictions of card and CPU agree on at least TRAIN_AGREE of the rows.
TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_AGREE = 3, 128, 0.995
# Launches of a kernel's timing loop (ms: median of single launches).
STEP_REPS = 30


def synthetic_adult():
    """Phase 13's dataset (numpy only: the same rows on the card and in the
    CPU worker): EXP_TRAIN + EXP_TEST rows drawn uniformly from the AC
    preset's adult domain, labelled by trained AC-S1's float64 forward with
    EXP_FLIP of the labels flipped."""
    import numpy as np

    from fairify_tpu_torch.data import loaders
    from fairify_tpu_torch.models import ingest
    from fairify_tpu_torch.models.mlp import predict_np
    from fairify_tpu_torch.verify import presets

    dom = presets.get("AC").query().domain
    lo, hi = (a.astype(np.int64) for a in dom.lo_hi())
    rng = np.random.default_rng(EXP_SEED)
    n = EXP_TRAIN + EXP_TEST
    X = rng.integers(lo, hi + 1, size=(n, len(lo))).astype(np.float64)
    ws, bs = ingest.load_trained("AC-S1", "cpu").numpy_params()
    y = predict_np(ws, bs, X).astype(int)
    y = np.where(rng.random(n) < EXP_FLIP, 1 - y, y)
    frame = {c: X[:, i] for i, c in enumerate(dom.columns)}
    frame[dom.label] = y
    return loaders.LoadedDataset("adult", frame, X[:EXP_TRAIN], y[:EXP_TRAIN], X[EXP_TRAIN:],
                                 y[EXP_TRAIN:], dom.label)


def experiment_cfg(work: str, tag: str):
    from fairify_tpu_torch.verify import presets
    from fairify_tpu_torch.verify.config import EngineConfig

    return presets.get("AC").with_(
        result_dir=os.path.join(work, f"exp-{tag}"), exact_certify_masks=False,
        capped_partitions=True, max_partitions=EXP_MAX_PARTITIONS, hard_timeout_s=EXP_HARD_S,
        engine=EngineConfig(frontier_size=512, attack_samples=128, bab_attack_samples=16,
                            soft_timeout_s=10.0, max_nodes=EXP_MAX_NODES, **TAIL))


def net_lists(net) -> dict:
    ws, bs = net.numpy_params()
    return {"weights": [w.tolist() for w in ws], "biases": [b.tolist() for b in bs]}


def experiment_record(res, cfg) -> dict:
    """The comparable outputs of one run_experiment: the first sweep's
    counts, ledger and CSV rows, the pairs, the localization, the repaired
    weights and the repair histories (JSON-ready)."""
    import numpy as np

    loc = res.localization
    return json.loads(json.dumps(dict(
        counts=res.report.counts, rows=sink_rows(cfg, res.report),
        pairs=[[np.asarray(a).tolist(), np.asarray(b).tolist()] for a, b in res.ce_pairs],
        ranked=[[l, j] for l, j, _ in loc.ranked] if loc else [],
        scores=[s for _, _, s in loc.ranked] if loc else [],
        history=res.repair_history, net=net_lists(res.fairer_net)), default=float))


def audit_record(out: dict) -> dict:
    """``experiment.audit``'s outputs, JSON-normalised (NaN metrics kept)."""
    return json.loads(json.dumps(out))


def train_record(ds, device: str) -> dict:
    """13b: train_mlp from init_mlp at AC-S1's widths on the synthetic rows:
    per-epoch losses and the final test-set predictions."""
    import torch

    from fairify_tpu_torch.models.mlp import predict
    from fairify_tpu_torch.models.train import train_mlp

    hist = []
    net = train_mlp(ds.X_train, ds.y_train, hidden=AC_SIZES[1:-1], epochs=TRAIN_EPOCHS,
                    batch_size=TRAIN_BATCH, seed=0, device=device, history=hist)
    with torch.no_grad():
        pred = predict(net, torch.tensor(ds.X_test, dtype=torch.float32, device=device))
    return {"history": hist, "pred": pred.cpu().numpy().astype(int).tolist()}


def phase13_cpu(work: str, card_weights: str) -> dict:
    """Phase 13's CPU side (in the CPU worker): run_experiment on trained
    AC-S1 without the re-verification, 13b's train_mlp, then, once the card
    has written its repaired weights to ``card_weights``, the
    re-verification and audit of those weights (``experiment.audit``)."""
    import numpy as np

    from fairify_tpu_torch.analysis import experiment
    from fairify_tpu_torch.models import ingest
    from fairify_tpu_torch.models.mlp import from_numpy

    t = time.perf_counter()
    ds = synthetic_adult()
    cfg = experiment_cfg(work, "cpu")
    net = ingest.load_trained("AC-S1", "cpu")
    res = experiment.run_experiment(net, cfg, "AC-S1", dataset=ds, repair_mode="both",
                                    verify_repaired=False, device="cpu")
    out = {"first": experiment_record(res, cfg), "first_s": time.perf_counter() - t}
    t = time.perf_counter()
    out["train"] = train_record(ds, "cpu")
    out["train_s"] = time.perf_counter() - t
    deadline = time.perf_counter() + 1200.0
    while not os.path.exists(card_weights):
        if time.perf_counter() > deadline:
            raise RuntimeError("phase 13: the card's repaired weights never came")
        time.sleep(0.5)
    t = time.perf_counter()
    z = np.load(card_weights)
    L = len(z.files) // 2
    fairer = from_numpy([z[f"w{i}"] for i in range(L)], [z[f"b{i}"] for i in range(L)],
                        device="cpu")
    out["audit"] = audit_record(experiment.audit(
        net, fairer, cfg.with_(result_dir=os.path.join(work, "exp-carried")), "AC-S1", ds,
        res.report, device="cpu"))
    out["audit_s"] = time.perf_counter() - t
    return out


def experiment_card(work: str, weights_out: str) -> dict:
    """13c's card side: run_experiment on trained AC-S1 with repair_mode
    "both", every launch count zeroed just before it and read just after;
    the repaired weights written to ``weights_out`` for the CPU worker."""
    import numpy as np
    import torch

    from fairify_tpu_torch.analysis import experiment
    from fairify_tpu_torch.models import ingest
    from fairify_tpu_torch.obs import launches

    ds = synthetic_adult()
    cfg = experiment_cfg(work, "card")
    net = ingest.load_trained("AC-S1", "cuda")
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    res = experiment.run_experiment(net, cfg, "AC-S1", dataset=ds, repair_mode="both",
                                    device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.counts()
    ws, bs = res.fairer_net.numpy_params()
    tmp = weights_out + ".tmp.npz"
    np.savez(tmp, **{f"w{i}": w for i, w in enumerate(ws)},
             **{f"b{i}": b for i, b in enumerate(bs)})
    os.replace(tmp, weights_out)
    for k in TRAIN_KERNELS[1:]:
        if counts[k] == 0:
            fail(f"13c: run_experiment launched no {k}")
    print(f"[13c card] run_experiment on trained AC-S1 over {len(res.report.outcomes)} "
          f"partitions in {wall:.3f} s: first sweep {res.report.counts}, repaired "
          f"{res.fairer_verdicts}; {len(res.ce_pairs)} pairs; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return dict(ds=ds, cfg=cfg, net=net, res=res, launch=counts, wall=wall,
                record=experiment_record(res, cfg),
                audit=audit_record(dict(fairer_verdicts=res.fairer_verdicts,
                                        metrics=res.metrics, routing=res.routing,
                                        causal_rates=res.causal_rates)))


def history_diffs(card: dict, cpu: dict) -> dict:
    """Card vs CPU repair histories: keys, bools and labels equal, losses and
    inconsistencies within EXP_H_REL, val_acc within EXP_ACC_ABS; the
    largest relative loss difference."""
    worst = 0.0
    if card.keys() != cpu.keys():
        fail(f"13c: repair arms {sorted(card)} vs {sorted(cpu)}")
    for arm in card:
        if len(card[arm]) != len(cpu[arm]):
            fail(f"13c: {arm} history lengths {len(card[arm])} vs {len(cpu[arm])}")
        for a, b in zip(card[arm], cpu[arm]):
            if a.keys() != b.keys():
                fail(f"13c: {arm} history records {a} vs {b}")
            for k in a:
                if k == "val_acc":
                    ok = abs(a[k] - b[k]) <= EXP_ACC_ABS
                elif isinstance(a[k], float):
                    rel = abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                    worst = max(worst, rel)
                    ok = rel <= EXP_H_REL
                else:
                    ok = a[k] == b[k]
                if not ok:
                    fail(f"13c: {arm} history {k}: card {a} vs CPU {b}")
    return {"max_rel_loss_diff": worst}


def weight_err(card: dict, cpu: dict) -> float:
    """Largest |card - CPU| weight difference over EXP_W_REL * |w| + EXP_W_ABS."""
    import numpy as np

    worst = 0.0
    for k in ("weights", "biases"):
        for a, b in zip(card[k], cpu[k]):
            a, b = np.asarray(a), np.asarray(b)
            worst = max(worst, float((np.abs(a - b) / (EXP_W_REL * np.abs(b) + EXP_W_ABS)).max()))
    return worst


def experiment_vs_cpu(exp: dict, cpu: dict, smi: str) -> dict:
    """13c's checks: the first sweep's counts, ledger and CSV rows, pairs and
    localization ranking card = CPU; the repaired weights and histories
    within tolerance; on the card's repaired weights the CPU worker's
    re-verification and audit equal the card's."""
    import numpy as np

    card, first = exp["record"], cpu["first"]
    for k in ("counts", "rows", "pairs", "ranked"):
        if card[k] != first[k]:
            fail(f"13c: first sweep {k} differ, card vs CPU")
    sc, sp = np.asarray(card["scores"]), np.asarray(first["scores"])
    if sc.shape != sp.shape or not np.allclose(sc, sp, rtol=1e-5, atol=0):
        fail(f"13c: localization scores {sc} vs {sp}")
    werr = weight_err(card["net"], first["net"])
    if werr > 1.0:
        fail(f"13c: repaired weights card vs CPU at {werr:.3f} x tolerance")
    hist = history_diffs(card["history"], first["history"])
    if exp["audit"] != cpu["audit"]:
        bad = {k: (exp["audit"][k], cpu["audit"][k]) for k in exp["audit"]
               if exp["audit"][k] != cpu["audit"][k]}
        fail(f"13c: audit of the card's repaired weights, card vs CPU: {bad}")
    res = exp["res"]
    print(f"[13c card = CPU] first sweep {card['counts']}, ledger and CSV rows, "
          f"{len(card['pairs'])} pairs and the localization {card['ranked']} equal; repaired "
          f"weights within {werr:.4f} x tolerance, history {hist}; on the card's repaired "
          f"weights: fairer_verdicts {res.fairer_verdicts}, routing {res.routing}, "
          f"causal_rates {res.causal_rates} equal (CPU first part {cpu['first_s']:.1f} s, "
          f"audit {cpu['audit_s']:.1f} s); success {res.success}; selected "
          f"{[h.get('selected') for h in card['history'].get('retrain', []) if 'selected' in h]}"
          f"; {smi}", flush=True)
    return dict(weight_err_x_tol=werr, **hist)


def train_vs_cpu(ds, cpu: dict, smi: str) -> dict:
    """13b: train_mlp on the card (every count zeroed before it) against the
    CPU worker's: per-epoch losses within EXP_H_REL, test predictions equal on
    at least TRAIN_AGREE of the rows."""
    import numpy as np
    import torch

    from fairify_tpu_torch.obs import launches

    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    rec = train_record(ds, "cuda")
    wall = time.perf_counter() - t0
    counts = launches.counts()
    want = (EXP_TRAIN // TRAIN_BATCH) * TRAIN_EPOCHS
    if counts["train_step"] != want:
        fail(f"13b: {counts['train_step']} train_step launches, expected {want}")
    hc, hp = np.asarray(rec["history"]), np.asarray(cpu["history"])
    rel = float((np.abs(hc - hp) / np.abs(hp)).max())
    agree = int((np.asarray(rec["pred"]) == np.asarray(cpu["pred"])).sum())
    n = len(rec["pred"])
    if rel > EXP_H_REL or agree < TRAIN_AGREE * n:
        fail(f"13b: losses {hc} vs {hp} (rel {rel:.2e}), predictions agree on {agree}/{n}")
    print(f"[13b train_mlp] AC-S1 widths from init_mlp, {TRAIN_EPOCHS} epochs at B = "
          f"{TRAIN_BATCH} on {EXP_TRAIN} synthetic rows: {counts['train_step']} launches in "
          f"{wall:.3f} s; epoch losses card {hc.tolist()} / CPU {hp.tolist()} (max rel "
          f"{rel:.2e}); test predictions equal on {agree} of {n}; {smi}", flush=True)
    return dict(launches=counts["train_step"], wall_s=wall, loss_rel=rel, agree=agree, rows=n)


def step_err(got, want) -> float:
    """Largest |got - want| over STEP_REL * |want| + STEP_ABS * max |want|."""
    scale = float(want.abs().max()) or 1.0
    return float(((got - want).abs() / (STEP_REL * want.abs() + STEP_ABS * scale)).max())


def step_verdict(k, p) -> float:
    """A kernel step's (theta, m, v, losses) against the plain version's, as
    a multiple of the tolerance (<= 1 passes)."""
    loss = float(((k[3] - p[3]).abs() / (STEP_REL * p[3].abs())).max())
    return max(step_err(k[0], p[0]), step_err(k[1], p[1]), step_err(k[2], p[2]), loss)


def library_step_ms(flat, loss_fn, lr: float, launches: int = 50):
    """The library yardstick of one training step: ``torch.autograd`` of the
    same loss on a leaf copy of theta (``flat``) and
    ``torch.optim.Adam(fused=True, capturable=True)``, captured once in a
    CUDA graph after three warm-up steps on a side stream, then
    ``launches`` replays between two events, per replay (device only).  None
    if the capture fails (the reason printed)."""
    import torch

    try:
        opt = torch.optim.Adam([flat], lr=lr, fused=True, capturable=True)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            for _ in range(3):
                opt.zero_grad(set_to_none=True)
                loss_fn().backward()
                opt.step()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        opt.zero_grad(set_to_none=True)
        with torch.cuda.graph(g):
            loss_fn().backward()
            opt.step()
        g.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            g.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / launches
    except Exception as exc:  # the yardstick only: report it and go on
        print(f"[library step] capture failed: {exc!r}", flush=True)
        return None


def run_steps(state, fn, steps: int = 1):
    """``steps`` steps of ``fn(theta, m, v, t, i)`` on copies of ``state``
    ``(theta, m, v, t)``: ``(theta, m, v, losses)``."""
    import torch

    th, m, v = (a.clone() for a in state[:3])
    losses = [fn(th, m, v, state[3] + i + 1, i).reshape(1) for i in range(steps)]
    return th, m, v, torch.cat(losses)


def check_step(name: str, state, launch, plain, prepare=None, cost=None, library=None,
               frozen=None, run100: bool = True, reps: int = STEP_REPS) -> dict:
    """13a on one training kernel at one shape.  One step from ``state``
    against the plain version; two launches bit-equal; a mutant (theta's
    largest entry moved by 1e-3) rejected; over 100 steps the losses within
    RUN_REL; with ``frozen`` (the masked entries, whose m and v are 0 in
    ``state``) every masked entry of theta, m and v bit-unchanged and a
    launch without its mask rejected; then, with ``prepare``, the times:
    the wrapper's median, its C entry point alone, the plain version's, the
    library step's and the bound of ``cost`` (flops, bytes)."""
    import torch

    k, p, k2 = run_steps(state, launch), run_steps(state, plain), run_steps(state, launch)
    err = step_verdict(k, p)
    if err > 1.0:
        fail(f"{name}: kernel vs plain at {err:.3f} x tolerance")
    if not all(torch.equal(a, b) for a, b in zip(k, k2)):
        fail(f"{name}: two launches on the same inputs differ")
    bad = k[0].clone()
    bad[int(torch.argmax(bad.abs()))] += 1e-3
    if step_verdict((bad,) + tuple(k[1:]), p) <= 1.0:
        fail(f"{name}: the mutant theta passed the check")
    out = {"err_x_tol": err, "max_abs_err": float((k[0] - p[0]).abs().max())}
    notes = ["bit-equal twice", "mutant rejected"]
    if frozen is not None:
        th0 = state[0]

        def untouched(r):
            return (torch.equal(r[0][frozen], th0[frozen]) and not r[1][frozen].any()
                    and not r[2][frozen].any())

        if not untouched(k):
            fail(f"{name}: a masked entry of theta, m or v moved")
        if untouched(run_steps(state, lambda th, m, v, t, i: launch(th, m, v, t, i, False))):
            fail(f"{name}: the launch without its mask kept every masked entry")
        out["frozen"] = int(frozen.sum())
        notes.append(f"{out['frozen']} masked entries bit-unchanged, the unmasked launch "
                     f"rejected")
    if run100:
        lk, lp = run_steps(state, launch, 100)[3], run_steps(state, plain, 100)[3]
        out["run100_loss_rel"] = float(((lk - lp).abs() / lp.abs()).max())
        if out["run100_loss_rel"] > RUN_REL:
            fail(f"{name}: 100-step losses differ by {out['run100_loss_rel']:.2e} relative")
        notes.append(f"100-step losses within {out['run100_loss_rel']:.2e}")
    if prepare is not None:
        th, m, v = (a.clone() for a in state[:3])
        t = state[3] + 1
        _, ms = timed(lambda: launch(th, m, v, t, 0), reps)
        _, plain_ms = timed(lambda: plain(th, m, v, t, 0), 5)
        split = time_split(lambda: launch(th, m, v, t, 0), prepare(th, m, v, t))
        b_ms, b_by = bound(*cost)
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, time_split=split,
                   library_ms=library() if library else None)
        notes.append(f"{ms:.4f} ms (C entry point alone {split['entry_ms']:.4f} ms), plain "
                     f"{plain_ms:.4f} ms, library {fmt_ms(out['library_ms'])}, bound "
                     f"{b_ms:.6f} ms ({b_by})")
    print(f"[kernel {name}] kernel vs plain {err:.3f} x tolerance (max |dtheta| "
          f"{out['max_abs_err']:.3g}); " + "; ".join(notes), flush=True)
    return out


def train_kernel_checks(exp: dict) -> dict:
    """13a: rows 25-28 against their plain versions at the path's shapes —
    row 25 at train_mlp's B = 128 (standardized synthetic rows, init_mlp at
    AC-S1's widths, 5 plain steps in), row 26 at masked_repair's B = 32 and
    its ragged last batch (trained AC-S1, raw rows, the mask of 13c's
    localized neurons, 5 masked plain steps in), row 27 at B = 64 on 13c's
    pairs with their consensus labels (anchored at trained AC-S1, 5 plain
    steps in), row 28 over all of 13c's pairs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fairify_tpu_torch.analysis import repair
    from fairify_tpu_torch.models.mlp import alive_flat, init_mlp, pack_params
    from fairify_tpu_torch.ops import train_step as ts

    ds, res, net = exp["ds"], exp["res"], exp["net"]
    sizes, dev, lr = list(AC_SIZES), net.device, 1e-3
    alive = alive_flat(net)
    f32 = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev)
    zeros = lambda th: (torch.zeros_like(th), torch.zeros_like(th))
    rows = {}

    # Row 25.
    X = ds.X_train.astype(np.float32)
    sd = X.std(axis=0)
    sd[sd == 0] = 1.0
    Xs, y = f32((X - X.mean(axis=0)) / sd), f32(ds.y_train)
    order = torch.tensor(np.random.default_rng(0).permutation(EXP_TRAIN), device=dev)
    B = TRAIN_BATCH
    bat = lambda i: order[(i % (EXP_TRAIN // B)) * B:(i % (EXP_TRAIN // B) + 1) * B]
    th = pack_params(init_mlp(sizes, 0, device=dev))
    st = (th,) + zeros(th)
    for i in range(5):
        ts.bce_adam_step_plain(*st, Xs, y, bat(i), sizes, alive, i + 1, lr)
    st = st + (5,)
    flat = st[0].clone().requires_grad_(True)
    rows["train_step"] = check_step(
        "row 25 train_step B=128", st,
        lambda th, m, v, t, i, masked=True: ts.bce_adam_step(
            th, m, v, Xs, y, bat(5 + i), sizes, alive, t, lr, kernel="train_step"),
        lambda th, m, v, t, i: ts.bce_adam_step_plain(th, m, v, Xs, y, bat(5 + i), sizes,
                                                      alive, t, lr),
        prepare=lambda th, m, v, t: ts._bce_launch(th, m, v, Xs, y, bat(5), sizes, alive, t,
                                                   lr, None, torch.empty(1, device=dev))
        + (None,),
        cost=ts.step_cost(sizes, B),
        library=lambda: library_step_ms(flat, lambda: F.binary_cross_entropy_with_logits(
            ts.forward_flat(flat, sizes, alive, Xs[bat(5)]), y[bat(5)]), lr))

    # Row 26.
    Xr, yr = f32(ds.X_train), f32(ds.y_train)
    targets = [(l, j) for l, j, _ in res.localization.ranked]
    mask = pack_params(repair.neuron_gradient_masks(net, targets))
    frozen = mask == 0
    order = torch.tensor(np.random.default_rng(1).permutation(EXP_TRAIN), device=dev)
    B = 32
    fb = lambda i: order[(i % (EXP_TRAIN // B)) * B:(i % (EXP_TRAIN // B) + 1) * B]
    th = pack_params(net)
    st = (th,) + zeros(th)
    for i in range(5):
        ts.bce_adam_step_plain(*st, Xr, yr, fb(i), sizes, alive, i + 1, lr, mask=mask)
    st = st + (5,)
    fit = lambda idx: (
        lambda th, m, v, t, i, masked=True: ts.bce_adam_step(
            th, m, v, Xr, yr, idx(i), sizes, alive, t, lr, mask=mask if masked else None,
            kernel="fit_step"),
        lambda th, m, v, t, i: ts.bce_adam_step_plain(th, m, v, Xr, yr, idx(i), sizes, alive,
                                                      t, lr, mask=mask))
    flat = st[0].clone().requires_grad_(True)
    rows["fit_step"] = check_step(
        "row 26 fit_step B=32", st, *fit(lambda i: fb(5 + i)), frozen=frozen,
        prepare=lambda th, m, v, t: ts._bce_launch(th, m, v, Xr, yr, fb(5), sizes, alive, t,
                                                   lr, mask, torch.empty(1, device=dev))
        + (None,),
        cost=ts.step_cost(sizes, B, masked=True),
        library=lambda: library_step_ms(flat, lambda: F.binary_cross_entropy_with_logits(
            ts.forward_flat(flat, sizes, alive, Xr[fb(5)]), yr[fb(5)]), lr))
    ragged = order[(EXP_TRAIN // B) * B:]
    rows["fit_step"]["ragged"] = check_step(
        f"row 26 fit_step ragged B={ragged.numel()}", st, *fit(lambda i: ragged),
        frozen=frozen, run100=False)

    # Row 27.
    pairs = res.ce_pairs
    xs = f32(np.stack([p[0] for p in pairs]))
    xps = f32(np.stack([p[1] for p in pairs]))
    with torch.no_grad():
        yl = ((0.5 * (torch.sigmoid(net(xs)) + torch.sigmoid(net(xps)))) > 0.5).float()
    n = xs.shape[0]
    B = min(64, n)
    rng = np.random.default_rng(2)
    pidx = [torch.tensor(rng.integers(0, n, size=B), device=dev) for _ in range(106)]
    anchor = pack_params(net)
    wts = (0.5, 4.0, 1e-4)
    st = (anchor.clone(),) + zeros(anchor)
    for i in range(5):
        ts.pair_adam_step_plain(*st, anchor, xs, xps, yl, pidx[i], sizes, alive, i + 1, 5e-3,
                                *wts)
    st = st + (5,)
    flat = st[0].clone().requires_grad_(True)
    rows["pair_step"] = check_step(
        f"row 27 pair_step B={B}", st,
        lambda th, m, v, t, i, masked=True: ts.pair_adam_step(
            th, m, v, anchor, xs, xps, yl, pidx[5 + i], sizes, alive, t, 5e-3, *wts),
        lambda th, m, v, t, i: ts.pair_adam_step_plain(
            th, m, v, anchor, xs, xps, yl, pidx[5 + i], sizes, alive, t, 5e-3, *wts),
        prepare=lambda th, m, v, t: ts._pair_launch(
            th, m, v, anchor, xs, xps, yl, pidx[5], sizes, alive, t, 5e-3, wts,
            torch.empty(1, device=dev)) + (None,),
        cost=ts.step_cost(sizes, B, pair=True),
        library=lambda: library_step_ms(flat, lambda: ts.pair_loss(
            flat, anchor, xs[pidx[5]], xps[pidx[5]], yl[pidx[5]], sizes, alive, *wts), 5e-3))

    # Row 28.
    theta = st[0]
    k = ts.pair_inconsistency(theta, xs, xps, sizes, alive)
    k2 = ts.pair_inconsistency(theta, xs, xps, sizes, alive)
    p = ts.pair_inconsistency_plain(theta, xs, xps, sizes, alive).reshape(1)
    err = float((k - p).abs() / (STEP_REL * p.abs()))
    if err > 1.0 or not torch.equal(k, k2):
        fail(f"row 28: kernel {k.item()} vs plain {p.item()} ({err:.3f} x tolerance), "
             f"again {k2.item()}")
    if float(((k + 1e-3) - p).abs() / (STEP_REL * p.abs())) <= 1.0:
        fail("row 28: the mutant passed the check")
    _, ms = timed(lambda: ts.pair_inconsistency(theta, xs, xps, sizes, alive), STEP_REPS)
    _, plain_ms = timed(lambda: ts.pair_inconsistency_plain(theta, xs, xps, sizes, alive), 5)
    out = torch.empty(1, device=dev)
    split = time_split(lambda: ts.pair_inconsistency(theta, xs, xps, sizes, alive),
                       ts._inc_launch(theta, xs, xps, sizes, alive, out) + (None,))
    lib = graph_ms(lambda: ts.pair_inconsistency_plain(theta, xs, xps, sizes, alive), 50)
    b_ms, b_by = bound(*ts.inconsistency_cost(sizes, n))
    rows["pair_inconsistency"] = dict(err_x_tol=err, max_abs_err=float((k - p).abs()),
                                      ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                      library_ms=lib, time_split=split, pairs=n)
    print(f"[kernel row 28 pair_inconsistency n={n}] kernel vs plain {err:.3f} x tolerance, "
          f"bit-equal twice, mutant rejected; {ms:.4f} ms (C entry point alone "
          f"{split['entry_ms']:.4f} ms), plain {plain_ms:.4f} ms, library (the plain "
          f"forwards device-only) {fmt_ms(lib)}, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return rows


def experiment_phase(exp: dict, cpu: dict, smi: str) -> dict:
    """Phase 13 (13a-13c) after the CPU worker's side is out."""
    t0 = time.perf_counter()
    out = {"13c": experiment_vs_cpu(exp, cpu, smi), "13b": train_vs_cpu(exp["ds"], cpu["train"],
                                                                         smi),
           "13a": train_kernel_checks(exp)}
    print(f"[phase 13] the experiment path in {time.perf_counter() - t0:.3f} s (13c's card "
          f"side earlier: {exp['wall']:.3f} s; CPU side in the worker: "
          f"{cpu['first_s']:.3f} + {cpu['train_s']:.3f} + {cpu['audit_s']:.3f} s); {smi}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 14: the synthetic-data path (synthesize -> train -> export -> verify)
# and the synthesizer's kernels, rows 29-30
# ---------------------------------------------------------------------------

# 14b: fairify_tpu_torch.scripts.synthetic_models at its defaults on phase
# 12's synthetic German file (the real file is not in the repository).
SYN_ARGS = ("--preset", "GC", "--generators", "copula,ar,bootstrap", "--n", "2000",
            "--ar-epochs", "200", "--hidden", "50", "--epochs", "30", "--seed", "42")
# A draw may differ from the plain version's only at a near tie: a row whose
# first differing column has the reference's top two perturbed logits within
# SYN_TIE_REL * max(1, |top|) (the two sum the logits in other orders and
# their logarithms may differ by an ulp); at most SYN_TIE_CAP of the rows.
SYN_TIE_REL, SYN_TIE_CAP = 1e-5, 0.01
# The synthesizer's fit, card vs CPU.  Two orders of summation keep the
# trajectories within a few ulps until a pre-activation near 0 takes the
# other side of its ReLU in one of them; from then on the fits part (Adam
# turns the small gradients of rare one-hot slots into steps of lr).  On the
# host, the kernel's arithmetic against the plain version parts at epoch 11
# of the pipeline's fit, the JAX package against the plain version at epoch
# 23, and after 200 epochs the losses differ by 6.5e-3 and 2.6e-3 relative.
# So the fit's first SYN_TIGHT_EPOCHS epochs are held to EXP_W_REL * |w| +
# EXP_W_ABS and EXP_H_REL, as phase 13's trainings are; every epoch's loss of
# the whole fit to SYN_HIST_REL; its weights' distance is reported, not held.
# Row 29's 100-step losses (14a) are held to SYN_RUN_REL for the same reason.
SYN_TIGHT_EPOCHS, SYN_HIST_REL, SYN_RUN_REL = 5, 2e-2, 1e-3
# 14a's logit mutant: one class's bias in the first column moved by this.
SYN_LOGIT_SHIFT = 0.1
# 14a's row-29 shape: synthesize's hidden width and fit's batch.
SYN_HIDDEN, SYN_BATCH = 64, 256
# Worker processes besides the lattice worker (stopped when the run ends).
EXTRA_WORKERS = []


class SynthCapture:
    """What the CPU worker needs from one run of the pipeline script, taken
    by swapping recording wrappers into ``models.synth.ARColumnModel`` and
    ``verify.sweep`` from outside for the run: the autoregressive model's
    ``fit`` (its inputs, keywords, initial and final θ, loss history), its
    ``sample`` (seed, rows as class codes) and every ``verify_model``'s
    ``(model name, config, report)``."""

    def __enter__(self):
        import numpy as np

        from fairify_tpu_torch.models import synth
        from fairify_tpu_torch.verify import sweep

        self.fit, self.draw, self.reports = {}, {}, []
        self._orig = fit0, sample0, verify0 = (synth.ARColumnModel.fit,
                                               synth.ARColumnModel.sample, sweep.verify_model)
        cap = self

        def fit(model, X, **kw):
            host = lambda: model.theta.detach().cpu().numpy().copy()
            cap.fit.update(X=np.asarray(X), kw=kw, init=host(), card=model.card.copy(),
                           hidden=model.shape.H)
            hist = fit0(model, X, **kw)
            cap.fit.update(hist=list(hist), theta=host())
            return hist

        def sample(model, n, seed=0):
            rows = sample0(model, n, seed=seed)
            cap.draw.update(n=int(n), seed=int(seed), rows=rows - model.lo[None, :])
            return rows

        def verify(net, cfg, model_name="model", **kw):
            rep = verify0(net, cfg, model_name=model_name, **kw)
            cap.reports.append((model_name, cfg, rep))
            return rep

        synth.ARColumnModel.fit, synth.ARColumnModel.sample = fit, sample
        sweep.verify_model = verify
        return self

    def __exit__(self, *exc):
        from fairify_tpu_torch.models import synth
        from fairify_tpu_torch.verify import sweep

        synth.ARColumnModel.fit, synth.ARColumnModel.sample, sweep.verify_model = self._orig
        return False


def synth_card(work: str) -> dict:
    """14b's card side: the pipeline script at its defaults (SYN_ARGS) on a
    synthetic German file, every launch count zeroed just before it and read
    just after; then its outputs written for the CPU side, which starts in a
    worker process of its own (``--synth-cpu``)."""
    import numpy as np
    import torch

    from fairify_tpu_torch.data import loaders
    from fairify_tpu_torch.obs import launches
    from fairify_tpu_torch.scripts import synthetic_models

    base = os.path.join(work, "p14")
    data, out = os.path.join(base, "data"), os.path.join(base, "card")
    write_german(os.path.join(data, "german", "german.data"), GERMAN_ROWS, GERMAN_SEED)
    root = loaders.DEFAULT_DATA_ROOT
    loaders.DEFAULT_DATA_ROOT = data  # the script loads from the loaders' default root
    try:
        with SynthCapture() as cap:
            torch.cuda.synchronize()
            launches.reset()
            t0 = time.perf_counter()
            records = synthetic_models.main(list(SYN_ARGS) + ["--out", out, "--device", CARD])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launches.counts()
    finally:
        loaders.DEFAULT_DATA_ROOT = root
    fit, draw = cap.fit, cap.draw
    steps = fit["kw"]["epochs"] * -(-len(fit["X"]) // SYN_BATCH)
    if counts["synth_step"] != steps or counts["synth_draw"] != 1 or not counts["train_step"]:
        fail(f"14b: launches {counts}, expected {steps} synth_step and 1 synth_draw")
    for rec in records:
        print(f"[14b record] {json.dumps(rec)}", flush=True)
    print(f"[14b card] the pipeline at its defaults in {wall:.3f} s: {steps} synth_step, "
          f"1 synth_draw, {counts['train_step']} train_step launches; AR fit on "
          f"{len(fit['X'])} rows of {len(fit['card'])} columns (D = {int(fit['card'].sum())}), "
          f"loss {fit['hist'][0]:.6f} -> {fit['hist'][-1]:.6f}", flush=True)
    cfg0 = cap.reports[0][1]
    path_in, path_out = os.path.join(base, "synth_in.json"), os.path.join(base, "synth_cpu.json")
    np.savez(path_in + ".npz", X=fit["X"], init=fit["init"], theta=fit["theta"],
             card=fit["card"], rows=draw["rows"])
    write_json(path_in, dict(data=data, hidden=fit["hidden"], kw=fit["kw"], n=draw["n"],
                             seed=draw["seed"], soft=cfg0.soft_timeout_s,
                             hard=cfg0.hard_timeout_s, preset=SYN_ARGS[1],
                             models=[[r["model"], r["h5"]] for r in records if "h5" in r]))
    worker = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--synth-cpu",
                               path_in, path_out],
                              cwd=os.path.dirname(os.path.abspath(__file__)), process_group=0)
    EXTRA_WORKERS.append(worker)
    return dict(records=records, cap=cap, launch=counts, wall=wall, worker=worker,
                out=path_out, rows={name: sink_rows(cfg, rep) for name, cfg, rep in cap.reports})


def synth_cpu_worker(path_in: str, path_out: str) -> int:
    """``chip_smoke.py --synth-cpu IN OUT``: 14b's CPU side on the card's
    outputs (IN, from :func:`synth_card`): the same ``fit`` from the same
    inputs (the initial θ must equal the card's bit for bit); the plain draw
    from the card's fitted θ, judged against the card's rows by the
    near-tie rule; ``verify_model`` of each net the card trained, loaded from
    the file the pipeline wrote.  Results into OUT (θ into OUT.npz)."""
    import numpy as np
    import torch

    from fairify_tpu_torch.data import loaders
    from fairify_tpu_torch.models import ingest, synth
    from fairify_tpu_torch.ops import synth_step as ss
    from fairify_tpu_torch.verify import presets, sweep

    torch.set_num_threads(2)
    with open(path_in) as fp:
        spec = json.load(fp)
    z = np.load(path_in + ".npz")
    card = z["card"]
    res = {}
    t = time.perf_counter()
    m = synth.ARColumnModel.init(np.zeros_like(card), card - 1, hidden=spec["hidden"],
                                 seed=spec["kw"]["seed"], device="cpu")
    res["init_equal"] = bool(np.array_equal(m.theta.numpy(), z["init"]))
    res["hist"] = m.fit(z["X"], **spec["kw"])
    theta = m.theta.numpy()
    m = synth.ARColumnModel.init(np.zeros_like(card), card - 1, hidden=spec["hidden"],
                                 seed=spec["kw"]["seed"], device="cpu")
    res["hist_tight"] = m.fit(z["X"], **dict(spec["kw"], epochs=SYN_TIGHT_EPOCHS))
    np.savez(path_out + ".npz", theta=theta, theta_tight=m.theta.numpy())
    res["fit_s"] = time.perf_counter() - t
    t = time.perf_counter()
    theta, shp = torch.from_numpy(z["theta"]), ss.Shape(card, spec["hidden"], "cpu")
    keys = ss.column_keys(spec["seed"], len(card))
    rows = ss.synth_draw_plain(theta, shp, keys, spec["n"])
    pert = ss.perturbed_logits(theta, shp, keys, rows)
    ties, bad = ss.near_ties(z["rows"], rows.numpy(), pert.numpy(), card, SYN_TIE_REL)
    res["draw"] = dict(ties=ties, bad=bad[:20], n_bad=len(bad),
                       differ=int((z["rows"] != rows.numpy()).any(axis=1).sum()))
    res["draw_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ds = loaders.load("german", root=spec["data"])
    cfg = presets.get(spec["preset"]).with_(
        soft_timeout_s=spec["soft"], hard_timeout_s=spec["hard"],
        result_dir=os.path.join(os.path.dirname(path_out), "cpu"))
    res["models"] = {}
    for name, path in spec["models"]:
        net = (ingest.load_npz if path.endswith(".npz") else ingest.load_keras_h5)(path, "cpu")
        rep = sweep.verify_model(net, cfg, model_name=name, dataset=ds, resume=False,
                                 device="cpu")
        res["models"][name] = dict(counts=rep.counts, rows=sink_rows(cfg, rep),
                                   partitions=rep.partitions_total,
                                   test_acc=round(rep.original_acc, 4))
    res["verify_s"] = time.perf_counter() - t
    write_json(path_out, res)
    return 0


def synth_vs_cpu(card: dict, smi: str) -> dict:
    """14b's checks against the CPU worker: the initial θ bit-equal; the
    pipeline's fit, its loss history within SYN_HIST_REL (its weights'
    distance reported); the same fit over its first SYN_TIGHT_EPOCHS epochs
    (run again on the card, uncounted), losses within EXP_H_REL and weights
    within EXP_W_REL * |w| + EXP_W_ABS; the card's draw equal to the plain
    draw from the card's weights up to near ties (at most SYN_TIE_CAP of the
    rows); per trained net the counts, ledger and CSV rows, partitions and
    test accuracy equal."""
    import numpy as np

    from fairify_tpu_torch.models import synth

    fit = card["cap"].fit
    m = synth.ARColumnModel.init(np.zeros_like(fit["card"]), fit["card"] - 1,
                                 hidden=fit["hidden"], seed=fit["kw"]["seed"], device=CARD)
    tight = m.fit(fit["X"], **dict(fit["kw"], epochs=SYN_TIGHT_EPOCHS))
    tight_w = m.theta.cpu().numpy()
    cpu = worker_part(card["worker"], card["out"], "phase 14", last=True)
    if not cpu["init_equal"]:
        fail("14b: the CPU's initial synthesizer weights differ from the card's")
    rel = lambda a, b: float((np.abs(np.asarray(a) - b) / np.abs(b)).max())
    z = np.load(card["out"] + ".npz")
    h_rel, t_rel = rel(fit["hist"], cpu["hist"]), rel(tight, cpu["hist_tight"])
    w_err = float((np.abs(tight_w - z["theta_tight"])
                   / (EXP_W_REL * np.abs(z["theta_tight"]) + EXP_W_ABS)).max())
    drift = float(np.linalg.norm(fit["theta"] - z["theta"]) / np.linalg.norm(z["theta"]))
    if t_rel > EXP_H_REL or w_err > 1.0 or h_rel > SYN_HIST_REL:
        fail(f"14b: fit card vs CPU: the first {SYN_TIGHT_EPOCHS} epochs' losses at {t_rel:.2e} "
             f"relative and weights at {w_err:.3f} x tolerance; the whole fit's losses at "
             f"{h_rel:.2e} relative")
    dr, n = cpu["draw"], card["cap"].draw["n"]
    if dr["n_bad"] or dr["ties"] > SYN_TIE_CAP * n:
        fail(f"14b: the card's draw vs the plain draw from its weights: {dr}")
    for rec in card["records"]:
        name = rec["model"]
        c = cpu["models"][name]
        mine = {"counts": {k: rec[k] for k in ("sat", "unsat", "unknown")},
                "partitions": rec["partitions"], "test_acc": rec["test_acc"],
                "rows": card["rows"][name]}
        theirs = {k: c[k] for k in ("counts", "partitions", "test_acc", "rows")}
        if mine != theirs:
            bad = [k for k in mine if mine[k] != theirs[k]]
            fail(f"14b: {name} card vs CPU differ in {bad}")
    print(f"[14b card = CPU] AR fit: its first {SYN_TIGHT_EPOCHS} epochs' losses within "
          f"{t_rel:.2e} relative and weights within {w_err:.4f} x tolerance; all "
          f"{len(fit['hist'])} epochs' losses within {h_rel:.2e} relative, weights "
          f"{drift:.4f} apart in relative L2 (CPU {cpu['fit_s']:.1f} s); the card's "
          f"draw of {n} rows = the plain draw from its weights, {dr['differ']} rows differing, "
          f"{dr['ties']} at near ties (CPU {cpu['draw_s']:.1f} s); "
          f"{len(card['records'])} nets' counts, ledger and CSV rows, accuracy equal (CPU "
          f"verify {cpu['verify_s']:.1f} s); {smi}", flush=True)
    return dict(loss_rel=h_rel, tight_loss_rel=t_rel, tight_weight_err_x_tol=w_err,
                weight_drift=drift, draw=dr, fit_s=cpu["fit_s"], verify_s=cpu["verify_s"])


def synth_step_checks(card14: dict) -> dict:
    """14a, row 29 at the path's shape (the fit's 21 quantized columns, H =
    64, B = 256 and the ragged last batch), 5 plain steps in from synthesize's
    initial weights: :func:`check_step` (one step vs plain, bit-equal twice,
    a mutant, the times), 100 steps' losses within SYN_RUN_REL, then the
    padded classes' entries of θ, m and v bit-unchanged, a θ with one of
    them moved rejected."""
    import numpy as np
    import torch

    from fairify_tpu_torch.ops import synth_step as ss

    fit = card14["cap"].fit
    dev, lr = CARD, 3e-3
    shp = ss.Shape(fit["card"], fit["hidden"], dev)
    codes = torch.from_numpy(fit["X"].astype(np.int32)).to(dev)
    n = codes.shape[0]
    nb = n // SYN_BATCH
    order = torch.tensor(np.random.default_rng(0).permutation(n), device=dev)
    bat = lambda i: order[(i % nb) * SYN_BATCH:(i % nb + 1) * SYN_BATCH]
    th = torch.from_numpy(fit["init"]).to(dev)
    st = (th, torch.zeros_like(th), torch.zeros_like(th))
    for i in range(5):
        ss.synth_step_plain(*st, codes, bat(i), shp, i + 1, lr)
    st = st + (5,)
    pad = ss.padded_mask(shp).to(dev)

    def padded_kept(r) -> bool:
        return (torch.equal(r[0][pad], st[0][pad]) and not r[1][pad].any()
                and not r[2][pad].any())

    flat = st[0].clone().requires_grad_(True)

    def steps(idx):
        """check_step's launch and plain version on the batches idx(5 + i)."""
        return (lambda th, m, v, t, i, masked=True: ss.synth_step(
                    th, m, v, codes, idx(5 + i), shp, t, lr),
                lambda th, m, v, t, i: ss.synth_step_plain(
                    th, m, v, codes, idx(5 + i), shp, t, lr))

    rows = {}
    for tag, idx, full in (("B=256", bat, True), (f"ragged B={n - nb * SYN_BATCH}",
                                                   lambda i: order[nb * SYN_BATCH:], False)):
        launch, plain = steps(idx)
        extra = {}
        if full:
            extra = dict(
                prepare=lambda th, m, v, t: ss._step_launch(
                    th, m, v, codes, bat(5), shp, t, lr, torch.empty(1, device=dev)) + (None,),
                cost=ss.step_cost(shp, SYN_BATCH),
                library=lambda: library_step_ms(flat, lambda: ss.synth_loss(
                    ss.views(flat, shp), codes[bat(5)], shp), lr))
        r = check_step(f"row 29 synth_step {tag}", st, launch, plain, run100=False, **extra)
        if full:
            lk, lp = run_steps(st, launch, 100)[3], run_steps(st, plain, 100)[3]
            r["run100_loss_rel"] = float(((lk - lp).abs() / lp.abs()).max())
            if r["run100_loss_rel"] > SYN_RUN_REL:
                fail(f"row 29: 100-step losses differ by {r['run100_loss_rel']:.2e} relative")
        k = run_steps(st, launch)
        if not padded_kept(k):
            fail(f"row 29 {tag}: a padded class's entry of theta, m or v moved")
        bad = k[0].clone()
        bad[int(torch.nonzero(pad)[0])] += 1e-3
        if padded_kept((bad,) + tuple(k[1:])):
            fail(f"row 29 {tag}: the padded-entry mutant passed the check")
        r["padded"] = int(pad.sum())
        print(f"[kernel row 29 synth_step {tag}] {r['padded']} padded-class entries of theta, "
              f"m, v bit-unchanged; their mutant rejected"
              + (f"; 100-step losses within {r['run100_loss_rel']:.2e}" if full else ""),
              flush=True)
        rows[tag] = r
    out = rows["B=256"]
    out["ragged"] = rows[f"ragged B={n - nb * SYN_BATCH}"]
    return out


def synth_draw_checks(card14: dict) -> dict:
    """14a, row 30 at the path's shape (n = 2,000 rows from the card's fitted
    weights, the pipeline's seed): the kernel's rows against the plain
    version's under the near-tie rule, bit-equal twice, the uniforms of the
    widest column bit-equal to ``utils/prng.uniform``; a key moved by one
    and a logit moved by SYN_LOGIT_SHIFT both rejected; the times beside
    the bound, the plain version and the plain draw as a CUDA graph."""
    import numpy as np
    import torch

    from fairify_tpu_torch.ops import synth_step as ss
    from fairify_tpu_torch.utils import cuda_build

    fit, draw = card14["cap"].fit, card14["cap"].draw
    n, dev = draw["n"], CARD
    shp = ss.Shape(fit["card"], fit["hidden"], dev)
    kmax = shp.kmax
    th = torch.from_numpy(fit["theta"]).to(dev)
    keys = ss.column_keys(draw["seed"], shp.d)
    keys_d = keys.to(dev)
    col = int(np.argmax(fit["card"]))
    uni = torch.zeros((n, kmax), device=dev)
    k = ss.synth_draw(th, shp, keys, n, uni, col).long()
    k2 = ss.synth_draw(th, shp, keys, n).long()
    p = ss.synth_draw_plain(th, shp, keys_d, n)
    pert = ss.perturbed_logits(th, shp, keys_d, p).cpu().numpy()
    want = p.cpu().numpy()
    verdict = lambda got: ss.near_ties(got.cpu().numpy(), want, pert, fit["card"], SYN_TIE_REL)
    ties, bad = verdict(k)
    if bad or ties > SYN_TIE_CAP * n:
        fail(f"row 30: kernel vs plain: {len(bad)} rows off a near tie (first {bad[:5]}), "
             f"{ties} near ties")
    if not torch.equal(k, k2):
        fail("row 30: two launches on the same inputs differ")
    ref = ss.prng.uniform(keys_d[col], (n, kmax), minval=ss.TINY, maxval=1.0)
    real = (torch.arange(kmax, device=dev) < shp.card[col])[None, :].expand(n, -1)
    if not torch.equal(uni[real], ref[real]):
        fail(f"row 30: column {col}'s uniform draws differ from utils/prng.uniform")
    moved = keys.clone()
    moved[0, 1] = (moved[0, 1] + 1) & 0xFFFFFFFF
    mk = verdict(ss.synth_draw(th, shp, moved, n))
    th_bad = th.clone()
    c0 = int(np.bincount(want[:, 0]).argmax())
    th_bad[shp.layout["bh"][0] + c0] += SYN_LOGIT_SHIFT
    ml = verdict(ss.synth_draw(th_bad, shp, keys, n))
    for name, (mt, mb) in (("shifted key", mk), ("shifted logit", ml)):
        if not mb and mt <= SYN_TIE_CAP * n:
            fail(f"row 30: the {name} mutant passed the check")
    out8 = torch.empty((n, shp.d), dtype=torch.int32, device=dev)
    k32 = cuda_build.u32_keys(keys).to(dev)
    _, ms = timed(lambda: ss.synth_draw(th, shp, keys, n), STEP_REPS)
    _, plain_ms = timed(lambda: ss.synth_draw_plain(th, shp, keys_d, n), 5)
    split = time_split(lambda: ss.synth_draw(th, shp, keys, n),
                       ss._draw_launch(th, shp, k32, n, out8) + (None,))
    lib = graph_ms(lambda: ss.synth_draw_plain(th, shp, keys_d, n), 20)
    b_ms, b_by = bound(*ss.draw_cost(shp, n))
    err = float((uni[real] - ref[real]).abs().max())
    differ = int((k.cpu().numpy() != want).any(axis=1).sum())
    print(f"[kernel row 30 synth_draw n={n}] kernel vs plain: {differ} rows differ, {ties} at "
          f"near ties; bit-equal twice; column {col}'s uniforms bit-equal to prng.uniform; "
          f"the shifted key ({mk[0]} ties, {len(mk[1])} other rows) and the shifted logit "
          f"({ml[0]} ties, {len(ml[1])} other rows) rejected; {ms:.4f} ms (C entry point alone "
          f"{split['entry_ms']:.4f} ms), plain {plain_ms:.4f} ms, library (the plain draw as a "
          f"CUDA graph) {fmt_ms(lib)}, bound {b_ms:.6f} ms ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, time_split=split, rows=n, differing_rows=differ,
                near_tie_rows=ties)


def synth_phase(card14: dict, smi: str) -> dict:
    """Phase 14 (14a, 14b) after 14b's card side ran early."""
    t0 = time.perf_counter()
    out = {"14b": synth_vs_cpu(card14, smi),
           "14a": {"synth_step": synth_step_checks(card14),
                   "synth_draw": synth_draw_checks(card14)}}
    print(f"[phase 14] the synthetic-data path in {time.perf_counter() - t0:.3f} s (14b's card "
          f"side earlier: {card14['wall']:.3f} s); {smi}", flush=True)
    return out


def worker_part(worker, path: str, phase: str, last: bool = False) -> dict:
    """Wait for the CPU worker's results of ``phase`` at ``path`` (for the
    last part, its exit too); fail if it exits without them."""
    t = time.perf_counter()
    while not os.path.exists(path):
        if worker.poll() is not None or time.perf_counter() - t > 900:
            fail(f"the CPU worker exited with {worker.poll()} before {phase}'s CPU side "
                 f"was out")
        time.sleep(0.2)
    if last and worker.wait(timeout=60) != 0:
        fail(f"the CPU worker exited with {worker.returncode}")
    print(f"[card = CPU] waited {time.perf_counter() - t:.3f} s for {phase}'s CPU side",
          flush=True)
    with open(path) as fp:
        return json.load(fp)


def smt_and_run_sweep(work: str, smi: str, cpu: dict) -> dict:
    """Phase 12 (12a, 12b)."""
    t0 = time.perf_counter()
    out = {"smt": smt_tier_phase(work, smi, cpu["smt"]),
           "family": family12_phase(work, smi, cpu["family"])}
    print(f"[phase 12] SMT tier and run_sweep in {time.perf_counter() - t0:.3f} s (CPU side "
          f"in the worker: {cpu['smt_s']:.3f} + {cpu['family_s']:.3f} s); {smi}", flush=True)
    return out


def runtime_contracts(work: str, gc_net, gc_cfg, ac_net, ac_cfg, smi: str) -> dict:
    """Phase 11 (11a-11e)."""
    t0 = time.perf_counter()
    out = {"gc": depth_gc(work, gc_net, gc_cfg, smi), "ac": depth_ac(ac_net, ac_cfg, smi),
           "sync": sync_check(gc_net, gc_cfg, smi),
           "faults": fault_schedules(work, gc_net, gc_cfg, smi),
           "trace": trace_and_profiler(work, gc_net, gc_cfg, smi),
           "recheck": sampled_recheck(work, gc_net, gc_cfg, smi)}
    print(f"[phase 11] runtime contracts in {time.perf_counter() - t0:.3f} s; {smi}",
          flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from fairify_tpu_torch.models.mlp import seeded_net
    from fairify_tpu_torch.utils import cuda_build, num

    # --- phase 1
    smi = smi_line()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    num.check_policy()
    probe = start_draw_probe()
    info = cuda_build.build_all()
    print(f"[build] {len(cuda_build.SOURCES)} libraries in {info['seconds']:.2f} s "
          f"(compiled {info['compiled']})", flush=True)
    for name, log in info["ptxas"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    finish_draw_probe(probe)

    engine_cfg = smoke_engine_cfg()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    ac_net = seeded_net(AC_SIZES, seed=0, device="cuda")
    clock("phase 1b")
    # --- phase 1b: the lattice kernels; the CPU side of card = CPU runs in
    # a worker process beside the rest of phase 1b, phases 2-2c and 4
    lat = lattice_card_side(ac_net, engine_cfg, work)
    worker = lat["worker"]
    try:
        lat_rows = lattice_kernel_checks(ac_net, lat["presets"])
        return run_phases(torch, smi, engine_cfg, work, ac_net, lat_rows, worker, lat["card"],
                          lat["out"])
    finally:
        for w in [worker] + EXTRA_WORKERS:
            try:
                os.killpg(w.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            w.wait()


def run_phases(torch, smi, engine_cfg, work, ac_net, lat_rows, worker, lat_card,
               lat_out) -> int:
    from fairify_tpu_torch.models.mlp import flagship_net, seeded_net
    from fairify_tpu_torch.partition import grid as grid_mod
    from fairify_tpu_torch.verify import presets, sweep
    from fairify_tpu_torch.verify.config import EngineConfig
    from fairify_tpu_torch.verify.property import encode

    clock("phase 10a")
    # --- phase 10a, its card side: the trained nets load from their .npz
    # exports; trained AC-S1's stage 0, which the CPU worker repeats
    tnets = trained_nets("cuda")
    t = time.perf_counter()
    trained_s0 = trained_stage0(tnets["AC-S1"], trained_stage0_cfg(), TRAINED_S0_SPAN)
    print(f"[trained nets] {sorted(tnets)} loaded from their .npz exports; trained AC-S1's "
          f"stage 0 over AC partitions 0-{TRAINED_S0_SPAN} on the card in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    clock("phase 13c, card side")
    # --- phase 13c's card side, early: the CPU worker re-verifies and
    # audits the card's repaired weights beside phases 3-11
    exp_card = experiment_card(work, lat_out + ".card13.npz")
    clock("phase 14b, card side")
    # --- phase 14b's card side, early: its CPU side runs in a worker of its
    # own beside phases 2-13
    syn_card = synth_card(work)

    clock("phase 2")
    # --- phase 2: the stage-0 kernels
    gc_cfg = presets.get("GC").with_(result_dir=os.path.join(work, "gc"),
                                     soft_timeout_s=10.0, hard_timeout_s=600.0,
                                     exact_certify_masks=False, engine=engine_cfg)
    ac_cfg = presets.get("AC").with_(result_dir=os.path.join(work, "ac"),
                                     exact_certify_masks=False, engine=engine_cfg)
    gc_net = flagship_net(device="cuda")
    gc_rows = check_kernels(case_inputs("GC", gc_net, gc_cfg), gc_net, reps=5, invariance=True)
    ac_case = case_inputs("AC", ac_net, ac_cfg)
    ac_rows = check_kernels(ac_case, ac_net, reps=3, invariance=True)
    ac_rows["stage0_certify"]["geometry"] = kb_invariance("AC", ac_net, ac_case["kb"], 0)
    del ac_case
    # Off the main path, for coverage of the kernels' ε-relaxed (RA) terms
    # and V > 2 assignment pairs: one 2-chunk segment of the relaxed-AC grid.
    rx_cfg = presets.get("relaxed-AC").with_(exact_certify_masks=False,
                                             engine=engine_cfg, grid_chunk=512,
                                             mega_chunks=2)
    check_kernels(case_inputs("relaxed-AC", ac_net, rx_cfg), ac_net, reps=1)

    clock("phase 2b")
    # --- phase 2b: the refinement kernels on real AC-S1 stage-0 leftovers
    enc, lo, hi = leftovers(ac_net, ac_cfg, 2048, 8192)
    ac_rows["pgd_attack"] = check_pgd("AC", ac_net, enc, lo, hi, reps=3, steps=60,
                                      restarts=96, mutate=True)
    ac_rows["pgd_attack"]["retry_shape"] = check_pgd_retry("AC retry", ac_net, enc, lo, hi,
                                                           steps=60, restarts=96)
    ac_rows["pgd_attack"]["geometry"] = pgd_invariance("AC", ac_net, enc, lo[:4], hi[:4],
                                                       steps=60, restarts=96)
    genc = encode(gc_cfg.query())
    _, glo, ghi = sweep.build_partitions(gc_cfg)
    gc_rows["pgd_attack"] = check_pgd("GC", gc_net, genc, glo[:128], ghi[:128],
                                      reps=3, steps=60, restarts=96)
    bab_rows = {}
    for alpha in (0, 8):
        st, c = bab_queue(ac_net, enc, lo, hi, 512)
        bab_rows[alpha] = check_bab("AC", ac_net, st, c, alpha, rounds=8, reps=3,
                                    mutate=alpha > 0)
        bab_rows[alpha]["geometry"] = bab_invariance("AC", ac_net, st, c, alpha, rounds=8)
    ac_rows["bab_segment"] = dict(bab_rows[8], alpha0={
        k: bab_rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "live_rounds")})
    st, c = bab_queue(gc_net, genc, glo[:128], ghi[:128], 512)
    gc_rows["bab_segment"] = check_bab("GC", gc_net, st, c, 8, rounds=8, reps=3)
    renc, rlo, rhi = leftovers(ac_net, rx_cfg, 64, 1024)
    check_pgd("relaxed-AC", ac_net, renc, rlo, rhi, reps=1, steps=60, restarts=96)
    st, c = bab_queue(ac_net, renc, rlo, rhi, 64)
    check_bab("relaxed-AC", ac_net, st, c, 8, rounds=8, reps=1)
    ac_rows["sim_rows"] = check_sim_rows("AC", ac_net, ac_cfg, lo, hi, reps=5)
    gc_rows["sim_rows"] = check_sim_rows("GC", gc_net, gc_cfg, glo, ghi, reps=5)
    ac_rows["sim_rows"]["resim_split"] = resim_split(ac_net, ac_cfg, lo, hi)
    # K12's key kernel at a segment's keys: the AC grid's first, GC-1's one.
    seg_rows = lambda cfg, n: grid_mod.segment_spans(n, cfg.grid_chunk, cfg.mega_chunks)[1][0]
    n_ac = len(sweep.build_partitions(ac_cfg)[1])
    ac_rows["grid_keys"] = check_grid_keys("AC", ac_cfg, seg_rows(ac_cfg, n_ac)[1], reps=5)
    gc_rows["grid_keys"] = check_grid_keys("GC", gc_cfg, len(glo), reps=5)
    print(f"[tiny] {tiny_oracle_case()} oracle roots agree through K5/K6", flush=True)

    clock("phase 2c")
    # --- phase 2c: the Phase-S/L/P kernels on real AC-S1 leftovers, then on
    # relaxed-AC (ε = 5) leftovers for the RA widening
    ac_rows.update(check_phase_s_kernels("AC", ac_net, enc, lo[:512], hi[:512],
                                         reps=3, mutate=True, geometry=True))
    # The GC-1 twin's sign candidates all certify at their root: K8a's GC
    # times are the root pattern's.
    gc_rows.update(check_phase_s_kernels("GC", gc_net, genc, glo[:128], ghi[:128],
                                         reps=3, frontier=False))
    check_phase_s_kernels("relaxed-AC", ac_net, renc, rlo, rhi, reps=1)

    clock("phase 4")
    # --- phase 4: the bench's BaB ladder world on the card vs the CPU
    ladder_rows = {}
    for tag, phases in (("slice 2", TAIL), ("slice 3", SLICE3), ("default", {})):
        rep_d, rows_d, lnet, lcfg = ladder_world(work, "cuda", phases)
        ladder_rows[tag] = rows_d
        rep_c, rows_c, _, _ = ladder_world(work, "cpu", phases)
        if rows_d != rows_c or rep_d.counts != {"sat": 0, "unsat": 8, "unknown": 0}:
            fail(f"ladder world, {tag}: card {rows_d} vs CPU {rows_c}")
        check_outputs(rep_d, lcfg, lnet, "BaB-1", rep_d.kernel_launches)
        rep_h, rows_h, _, _ = ladder_world(work, "cuda", phases, max_nodes=1)
        rep_hc, rows_hc, _, _ = ladder_world(work, "cpu", phases, max_nodes=1)
        if rows_h != rows_hc:
            fail(f"ladder world, {tag}, max_nodes=1 (heuristic retry): card {rows_h} "
                 f"vs CPU {rows_hc}")
        print(f"[ladder {tag}] card = CPU: {rep_d.counts}; launches "
              f"{rep_d.kernel_launches}; max_nodes=1 (heuristic retry): {rep_h.counts}, "
              f"h_attempt {sum(o.h_attempt for o in rep_h.outcomes)}, launches "
              f"{rep_h.kernel_launches}", flush=True)

    clock("phase 7a-7d")
    # --- phase 7, its untimed checks: the AC-S1 family on the whole grid,
    # the zoo's CP and DF families, the chunk loop and the host frontier
    fam_nets = [ac_net] + [seeded_net(AC_SIZES, seed=s, device="cuda")
                           for s in FAMILY_SEEDS[1:]]
    fam_rows, fam_res, solo_res = family_grid(fam_nets, ac_cfg, reps=3)
    fam_chunk = family_chunk(fam_nets, ac_cfg, reps=3)
    zoo_launch = zoo_families(work, engine_cfg)
    chunk = chunk_loop_checks(work, gc_net, gc_cfg, ac_net, ac_cfg, reps=3)
    hf = host_frontier_checks(work, ac_net, enc, lo, hi, reps=3,
                              rows_dev=ladder_rows["slice 2"])
    clock("phase 8 kernels")
    # --- phase 8, its untimed checks: rows 13 and 17 at the chunk loop's and
    # the host frontier's shapes, the IBP family (rows 8 and 9) on the AC
    # grid, the ladder world on the IBP path; the native exact core loaded
    require_native_exact()
    k10_rows = k10_kernel_checks(ac_net, ac_cfg, enc, lo, hi, reps=3)
    k10_fam = k10_family(fam_nets, ac_cfg, reps=3)
    k10_ladder_launch = k10_ladder(work)

    # The CPU side of card = CPU ran beside phases 1b-2c, 4 and 7's checks;
    # the timed end-to-end phases 3, 5, 6 and 7's family run go without it.
    trained_cmp = lattice_card_vs_cpu(worker, lat_card, lat_out, trained_s0)

    clock("phase 3")
    # --- phase 3: the GC-1 main path (stage 0 decides every partition)
    rep, gc_launch, wall = run_sweep(gc_net, gc_cfg, "GC-1",
                                     required=("sim_and_bounds", "stage0_certify",
                                               "attack_flips", "parity", "grid_keys"))
    if rep.counts != {"sat": 2, "unsat": 199, "unknown": 0}:
        fail(f"GC-1 counts {rep.counts}, expected sat=2 unsat=199 unknown=0")
    thr = check_outputs(rep, gc_cfg, gc_net, "GC-1", gc_launch)
    print(f"[e2e GC-1] {rep.counts} in {wall:.3f} s = "
          f"{(rep.counts['sat'] + rep.counts['unsat']) / wall:.2f} partitions/s; "
          f"phases {thr['phases_s']}; launches {gc_launch}", flush=True)

    clock("phase 5")
    # --- phase 5: real size.  The whole AC grid (16,000 partitions, two
    # mega-segments) through verify_model with a short hard budget, then
    # the main path of this slice at depth: the first 2,048 partitions
    # through stage 0 -> PGD -> BaB -> heuristic retry.
    grid_cfg = ac_cfg.with_(
        result_dir=os.path.join(work, "ac-grid"), soft_timeout_s=0.02,
        hard_timeout_s=30.0, engine=EngineConfig(**TAIL, max_nodes=1000))
    n_grid = len(sweep.build_partitions(grid_cfg)[0])
    n_segs = len(grid_mod.segment_spans(n_grid, grid_cfg.grid_chunk,
                                        grid_cfg.mega_chunks)[1])
    rep_g, g_launch, wall_g = run_sweep(
        ac_net, grid_cfg, "AC-S1-grid", required=[k for k in SLICE2 if k != "sim_rows"])
    thr_g = check_outputs(rep_g, grid_cfg, ac_net, "AC-S1-grid", g_launch)
    if n_segs < 2 or sum(rep_g.counts.values()) != n_grid or any(
            g_launch[k] != n_segs for k in ("sim_and_bounds", "stage0_certify",
                                            "attack_flips", "parity")):
        fail(f"AC grid: {n_grid} partitions in {n_segs} segments, counts "
             f"{rep_g.counts}, launches {g_launch}")
    print(f"[AC-S1 grid] {n_grid} partitions in {n_segs} segments: {rep_g.counts} "
          f"(stage 0 + PGD decided {thr_g['stage0_decided']}, BaB and retry "
          f"{thr_g['bab_decided']}; decided_fraction {thr_g['decided_fraction']}) in "
          f"{wall_g:.3f} s under a 30 s hard budget; funnel {thr_g['funnel']}; "
          f"phases {thr_g['phases_s']}; launches {g_launch}", flush=True)
    tail_launch, tail_shapes, tail_resim = {}, {}, {}
    for tag, phases in (("slice 2", TAIL), ("slice 3", SLICE3)):
        tail_cfg = ac_cfg.with_(
            result_dir=os.path.join(work, f"ac-tail-{len(phases)}"), soft_timeout_s=0.02,
            hard_timeout_s=TAIL_HARD_S, engine=EngineConfig(**phases, max_nodes=1000))
        with ShapeLog() as shapes, ResimClock() as resim:
            rep_ac, launch, wall_ac = run_sweep(
                ac_net, tail_cfg, "AC-S1-twin", span=(0, 2048),
                required=SLICE2 if phases is TAIL else SLICE3_PATH, label=f"AC-S1 tail, {tag}")
        shapes.check(launch, f"AC-S1 tail, {tag}")
        if len(resim.calls) != launch["sim_rows"]:
            fail(f"AC-S1 tail, {tag}: {len(resim.calls)} parity_resim calls but "
                 f"{launch['sim_rows']} K12 launches (one each)")
        tail_resim[tag] = resim.summary(f"AC-S1 tail, {tag}")
        tail_launch[tag] = launch
        tail_shapes[tag] = shapes
        thr = check_outputs(rep_ac, tail_cfg, ac_net, "AC-S1-twin", launch)
        c = rep_ac.counts
        h_try = sum(o.h_attempt for o in rep_ac.outcomes)
        h_ok = sum(o.h_success for o in rep_ac.outcomes)
        reasons = {}
        with open(sweep.ledger_path(tail_cfg, rep_ac.sink_name)) as fp:
            for rec in (json.loads(line) for line in fp if line.strip()):
                if rec["verdict"] == "unknown":
                    why = rec.get("engine_reason")
                    reasons[why] = reasons.get(why, 0) + 1
        print(f"[AC-S1 tail, {tag}] partitions 0-2048: sat {c['sat']} unsat "
              f"{c['unsat']} unknown {c['unknown']} (stage 0 + PGD decided "
              f"{thr['stage0_decided']}, the engine and the retry decided "
              f"{thr['bab_decided']} (first pass by phase {thr['engine_decided']}), of "
              f"which the heuristic retry {h_ok} of {h_try} tried; unknown reasons "
              f"{reasons}; decided_fraction "
              f"{thr['decided_fraction']}) in {wall_ac:.3f} s; t_sign "
              f"{thr['phases_s'].get('engine_sign', 0.0):.3f} s, t_lp "
              f"{thr['phases_s'].get('engine_lp', 0.0):.3f} s, t_pair "
              f"{thr['phases_s'].get('engine_pair', 0.0):.3f} s; funnel {thr['funnel']}; "
              f"phases {thr['phases_s']}; launches {launch}; K5 launches by B "
              f"{shapes.pgd}; K6 launches by (alpha, slot-rounds) {shapes.bab}", flush=True)
    ac_launch = tail_launch["slice 3"]
    # K6 at the tails' launch shapes: every bucket timed on its first launch.
    bab_shapes = bab_by_shape(tail_shapes)

    clock("phase 6")
    # --- phase 6: this slice's main path.  The JAX engine's default
    # configuration (lattice phases on; max_nodes cut to 1,000) on the
    # AC-S1 twin over stress-AC and relaxed-AC partitions 0-1,024.
    lat_launch = {}
    for name, k9 in (("stress-AC", "lattice_scan"), ("relaxed-AC", "lattice_scan_ra")):
        cfg = presets.get(name).with_(
            result_dir=os.path.join(work, f"default-{name}"), exact_certify_masks=False,
            soft_timeout_s=DEFAULT_SOFT_S, hard_timeout_s=DEFAULT_HARD_S,
            engine=EngineConfig(max_nodes=1000))
        rep_d, launch, wall_d = run_sweep(ac_net, cfg, "AC-S1-twin", span=(0, 1024),
                                          required=DEFAULT_PATH + (k9,),
                                          label=f"{name} default")
        lat_launch[name] = launch
        thr = check_outputs(rep_d, cfg, ac_net, "AC-S1-twin", launch)
        first = thr["engine_decided"]
        if first.get("lattice_first", 0) == 0:
            fail(f"{name}: Phase E0 decided nothing ({first})")
        c = rep_d.counts
        reasons = {}
        with open(sweep.ledger_path(cfg, rep_d.sink_name)) as fp:
            for rec in (json.loads(line) for line in fp if line.strip()):
                if rec["verdict"] == "unknown":
                    why = rec.get("engine_reason")
                    reasons[why] = reasons.get(why, 0) + 1
        ph = thr["phases_s"]
        print(f"[{name} default] partitions 0-1,024: sat {c['sat']} unsat {c['unsat']} "
              f"unknown {c['unknown']}, decided_fraction {thr['decided_fraction']} in "
              f"{wall_d:.3f} s (stage 0 + PGD decided {thr['stage0_decided']}; the engine "
              f"and the retry {thr['bab_decided']}; first pass by phase {first}; retry "
              f"{sum(o.h_success for o in rep_d.outcomes)} of "
              f"{sum(o.h_attempt for o in rep_d.outcomes)} tried); engine t_lattice "
              f"{ph.get('engine_lattice', 0.0):.3f} s, t_sign {ph.get('engine_sign', 0.0):.3f}"
              f" s, t_lp {ph.get('engine_lp', 0.0):.3f} s, t_bab "
              f"{ph.get('engine_bab', 0.0):.3f} s, t_pair {ph.get('engine_pair', 0.0):.3f} "
              f"s; unknown reasons {reasons}; funnel {thr['funnel']}; phases {ph}; "
              f"launches {launch}", flush=True)
    clock("phase 10b")
    # --- phase 10b: trained AC-S1 in phase 6's configuration
    trained6 = {f"{p} {a}-{b}": trained_default(work, tnets["AC-S1"], p, (a, b))
                for p, (a, b) in TRAINED_DEFAULT}
    both = {v: sum(r["counts"][v] for r in trained6.values()) for v in JAX_STRESS_AC_S1}
    if both["unknown"] == 0 and both != JAX_STRESS_AC_S1:
        fail(f"trained AC-S1, stress-AC 0-4,096: {both}, the JAX package's row "
             f"{JAX_STRESS_AC_S1}")
    print(f"[stress-AC default, trained AC-S1, 0-4096] {both}; the JAX package's "
          f"stress-AC-scaled AC-S1 row {JAX_STRESS_AC_S1}", flush=True)
    clock("phase 7e")
    # --- phase 7, end to end: the AC-S1 family through verify_model(stage0=)
    fam_launch = family_tail(work, fam_nets, ac_cfg, fam_res, solo_res)
    clock("phase 8a, 8b, 8e")
    # --- phase 8, end to end: GC-1 and the AC grid on the IBP path; the
    # exact-certify pass over the AC grid
    gc8 = ibp_gc(work, gc_net, gc_cfg)
    grid8 = ibp_grid(work, ac_net, ac_cfg)
    exact8 = exact_pass_check(ac_net, ac_cfg)
    clock("phase 9")
    # --- phase 9: the mesh path (rows 14 and 6) end to end and at its
    # kernels' shapes, harsh pruning (row 3) and K7
    gc9 = mesh_gc(work, gc_net, gc_cfg)
    ac9 = mesh_ac(work, ac_net, ac_cfg)
    k9 = mesh_kernels(ac_net, ac_cfg, fam_nets, enc, lo, hi, reps=3)
    worlds9 = mesh_worlds(work, fam_nets, ac_cfg)
    harsh9 = harsh_check(ac_net, ac_cfg, reps=3)
    k7 = k7_check("AC-S1 twin", ac_net, lo, hi, reps=3)
    clock("phase 10c")
    # --- phase 10c, 10d: K7 on trained AC-S1's stage-0 leftovers; row 17
    # of the four trained nets against float64
    _, tlo, thi = leftovers(tnets["AC-S1"], ac_cfg, None, 8192)
    k7["trained"] = k7_check("AC-S1 trained", tnets["AC-S1"], tlo, thi, reps=3, more=False)
    trained17 = trained_forward_checks(tnets)
    clock("phase 11")
    # --- phase 11: the runtime contracts
    runtime_contracts(work, gc_net, gc_cfg, ac_net, ac_cfg, smi)
    clock("phase 12")
    # --- phase 12: the SMT tier and run_sweep, card = the CPU worker's runs
    smt_and_run_sweep(work, smi, worker_part(worker, lat_out + ".p12", "phase 12"))
    clock("phase 13")
    # --- phase 13: the experiment path, card = the CPU worker's runs; the
    # training kernels (rows 25-28) at its shapes
    exp13 = experiment_phase(exp_card, worker_part(worker, lat_out + ".p13", "phase 13",
                                                   last=True), smi)
    clock("phase 14")
    # --- phase 14: the synthetic-data path, card = its CPU worker's runs; the
    # synthesizer's kernels (rows 29-30) at its shapes
    syn14 = synth_phase(syn_card, smi)
    shutil.rmtree(work, ignore_errors=True)
    # K8a and KB by shape in every window of the run
    clock("shapes")
    cert_shapes = cert_by_shape()
    clock("summary")

    table = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    for name in REPLACES:
        if name in SYNTH_KERNELS:
            r, n = syn14["14a"][name], syn_card["launch"][name]
            print(f"[summary] {name}: launches the pipeline (14b) {n}; median {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])}, bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
            table.append(dict({"name": name, "route": "cuda", "source": SOURCES[name],
                               "replaces": REPLACES[name], "launches": n,
                               "path": "scripts.synthetic_models (14b)",
                               "library_ms": r["library_ms"], **{k: r[k] for k in keys}},
                              **{k: r[k] for k in ("err_x_tol", "time_split", "padded",
                                                   "run100_loss_rel", "ragged", "rows",
                                                   "differing_rows", "near_tie_rows")
                                 if k in r}))
            continue
        if name in TRAIN_KERNELS:
            r = exp13["13a"][name]
            n = exp13["13b"]["launches"] if name == "train_step" else exp_card["launch"][name]
            path = "train_mlp (13b)" if name == "train_step" else "run_experiment (13c)"
            print(f"[summary] {name}: launches {path} {n}; median {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, library {fmt_ms(r['library_ms'])}, bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']})", flush=True)
            table.append(dict({"name": name, "route": "cuda", "source": SOURCES[name],
                               "replaces": REPLACES[name], "launches": n, "path": path,
                               "library_ms": r["library_ms"], **{k: r[k] for k in keys}},
                              **{k: r[k] for k in ("err_x_tol", "time_split", "frozen",
                                                   "run100_loss_rel", "ragged", "pairs")
                                 if k in r}))
            continue
        if name in MESH_KERNELS:
            if name == "role_certify":
                r = k9["chunk"]
                row = dict(launches=gc9["1x1"]["launch"][name],
                           launches_gc1_3_shards=gc9["3 shards"]["launch"][name],
                           launches_ac_tail_mesh=ac9["mesh"]["launch"][name],
                           launches_ladder_mesh=worlds9["slice 3"][name],
                           chunk_boxes=r["boxes"],
                           host_frontier={k: k9["host_frontier"][k] for k in keys + (
                               "boxes", "alpha_iters")},
                           family_chunk={k: k9["family_chunk"][k] for k in (
                               "ms", "solo_sum_ms", "plain_ms", "max_abs_err", "bound_ms",
                               "bound_by", "M", "boxes")})
            else:
                r = harsh9 if name == "sim_stats" else k7
                row = dict(launches=r["launches"])
                row.update({k: r[k] for k in ("partitions", "boxes", "iters", "err_x_slack",
                                              "excused", "time_split", "draw", "geometry",
                                              "unwidened", "launch_shapes", "trained")
                            if k in r})
            print(f"[summary] {name}: launches {row['launches']}; median {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})", flush=True)
            table.append(dict({"name": name, "route": "cuda", "source": SOURCES[name],
                               "replaces": REPLACES[name],
                               "also_replaces": ALSO_REPLACES.get(name, []),
                               "library_ms": r.get("library_ms"), **{k: r[k] for k in keys}},
                              **row))
            continue
        if name in K10:
            r, fr = k10_rows[name], k10_fam[name]
            print(f"[summary] {name}: launches AC grid IBP {grid8['launch'][name]} / GC-1 "
                  f"IBP {gc8['launch'][name]} / IBP family {fr['launches']} / ladder IBP "
                  f"{k10_ladder_launch[name]}; AC chunk median {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
                  flush=True)
            row = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "also_replaces": ALSO_REPLACES[name],
                "launches": grid8["launch"][name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                "chunk_shape": r.get("rows", r.get("role_boxes")),
                "launches_gc1_ibp": gc8["launch"][name],
                "launches_ladder_ibp": k10_ladder_launch[name],
                "family_chunk": {k: fr[k] for k in keys + (
                    "solo_sum_ms", "library_ms", "M", "launches")},
                "host_frontier": {k: r["host_frontier"].get(k) for k in keys + (
                    "library_ms", "rows", "role_boxes", "time_split", "live_boxes",
                    "geometry") if k in r["host_frontier"]},
            }
            if name == "role_bounds":
                row["crown"] = {k: r["crown"][k] for k in keys + (
                    "err_x_tol", "time_split", "geometry")}
                row["err_x_slack"] = r["err_x_slack"]
                row["time_split"], row["geometry"] = r["time_split"], r["geometry"]
                row["family_chunk"].update(time_split=fr["time_split"],
                                           geometry=fr["geometry"])
                row["launches_by_shape"] = cert_shapes[name]
            else:
                row["launches_by_rows"] = {str(k): v for k, v in sorted(grid8["rows"].items())}
                row["geometry"] = r["geometry"]
            table.append(row)
            continue
        if name in LATTICE_KERNELS:
            r = lat_rows[name]
            n = lat_launch[LATTICE_KERNELS[name]][name]
            print(f"[summary] {name}: launches {LATTICE_KERNELS[name]} default {n} / "
                  f"{'relaxed' if name != 'lattice_scan_ra' else 'stress'}-AC default "
                  f"{lat_launch[LATTICE_OTHER[name]][name]}; median {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}) at V={r['V']}, chunk {r['chunk']}", flush=True)
            table.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": n, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "launches_other_preset": lat_launch[LATTICE_OTHER[name]][name],
                **{k: r[k] for k in ("V", "chunk", "overflow_launches", "relaxed",
                                     "checked_chunks", "scratch", "geometry") if k in r}})
            continue
        r, g = ac_rows[name], gc_rows[name]
        print(f"[summary] {name}: launches AC-S1 tail slice 3 {ac_launch[name]} / "
              f"slice 2 {tail_launch['slice 2'][name]} / AC grid {g_launch[name]} / "
              f"GC-1 {gc_launch[name]} / stress-AC default {lat_launch['stress-AC'][name]} "
              f"/ relaxed-AC default {lat_launch['relaxed-AC'][name]}; AC median "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']})", flush=True)
        row = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": ac_launch[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "launches_slice2_tail": tail_launch["slice 2"][name],
            "launches_ac_grid": g_launch[name], "launches_gc1": gc_launch[name],
            "launches_stress_default": lat_launch["stress-AC"][name],
            "launches_relaxed_default": lat_launch["relaxed-AC"][name],
            "gc": {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                                     "library_ms", "time_split", "draw") if k in g},
        }
        for extra in ("alpha0", "root", "role_boxes", "geometry", "live_rows", "time_split",
                      "draw", "resim_split", "floor", "keys"):
            if extra in r:
                row[extra] = r[extra]
        if name in ("sim_and_bounds", "parity", "attack_flips"):
            row["gc"]["geometry"] = g.get("geometry")
        if name == "sim_rows":
            row["parity_resim_tails"] = tail_resim
        if name == "pgd_attack":
            row["retry_shape"] = {k: r["retry_shape"][k] for k in keys + (
                "boxes", "trajectories", "near_diffs")}
            row["launches_by_B"] = {str(k): v for k, v in
                                    sorted(tail_shapes["slice 3"].pgd.items())}
        if name in cert_shapes:
            row["launches_by_shape"] = cert_shapes[name]
        if name == "bab_segment":
            row["launches_by_shape"] = {t: bab_shapes[t] for t in ("slice 2", "slice 3")}
            row["frequent_shape"] = {k: bab_shapes["frequent"][k] for k in keys + (
                "alpha_iters", "bucket", "live_rounds")}
        if name == "role_logits":
            row["row17_ms"] = r["row17_ms"]
            row["gc"]["row17_ms"] = g["row17_ms"]
            row["gc"]["library_ms"] = g["library_ms"]
        if name in chunk["rows"]:  # rows 1, 10 and 15 (stage 0) at one chunk
            row["chunk_loop"] = {k: chunk["rows"][name].get(k) for k in keys + (
                "launches", "library_ms", "time_split", "live_rows", "launch_shapes", "geometry")
                if k in chunk["rows"][name]}
            row["launches_chunk_loop_gc1"] = chunk["gc_launch"][name]
            row["also_replaces"] = ALSO_REPLACES[name]
        if name in fam_rows:  # rows 5 and 7 (families) and 15 (host frontier)
            fr = fam_rows[name]
            row["family_segment"] = {k: fr[k] for k in keys + (
                "solo_sum_ms", "ms_segments", "solo_sum_ms_segments", "M", "boxes",
                "launches", "library_ms", "time_split", "geometry") if k in fr}
            row["family_chunk"] = dict({k: fam_chunk[name][k] for k in (
                "ms", "solo_sum_ms", "plain_ms", "bound_ms", "bound_by", "M", "boxes",
                "library_ms", "time_split") if k in fam_chunk[name]},
                launches={z: zoo_launch[z][name] for z in zoo_launch})
            row["launches_family_tail"] = fam_launch[name]
            hk = ("kb_alpha8", "kb_alpha0") if name == "stage0_certify" else ("kc",)
            row["host_frontier"] = dict({k: {x: v for x, v in hf[k].items()
                                             if x not in ("flops", "bytes")} for k in hk},
                                        launches=hf["launches"][name])
        table.append(row)
    print(f"[exact-certify] AC grid sv_time_s {exact8['sv_time_s']:.3f} s; GC-1 "
          f"sv_time_s IBP {gc8['thr']['phases_s'].get('prune_exact_certify')} s, CROWN "
          f"{gc8['crown_exact']['phases'].get('prune_exact_certify')} s", flush=True)
    print(f"[trained summary] {json.dumps(dict(stage0_card_vs_cpu=trained_cmp, stress_ac_default=trained6, row17_err_x_tol=trained17), default=str)}", flush=True)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--lattice-cpu":
        sys.exit(lattice_cpu_worker(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 4 and sys.argv[1] == "--synth-cpu":
        sys.exit(synth_cpu_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
