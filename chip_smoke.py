"""Drive the PyTorch port (lightgbm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. set-up: the card's name and power limit, and the build of every kernel
   from ``lightgbm_tpu_torch/csrc`` into ``build/`` (one nvcc per source,
   all started together; timed); the SASS census of atomic, reduction and
   warp-match instructions by kernel;
2. kernels vs plain: each kernel against its plain PyTorch version on the
   same inputs, times by CUDA events (median of 25), bounds from these
   inputs:
   - K1 (``ops/hist_wave.hist_wave``) packed and fused in 2xbf16 and in
     int16 at the main path's shape (1,000,000 rows x 28 features x 256
     bins, 63 leaves), and 2xbf16 unfused at a ragged shape (3,001 x 5 x
     64, 7 leaves); int8 on the ragged shape; the triple layout (42
     leaves) in 2xbf16 and int16, fused and unfused; a ragged int16 case
     and a 2xbf16 one whose leaf ids lie past the kernel's 4,096-entry slot
     table.  Bins are drawn over all of [0, B).  Then 2xbf16 fused at the
     main shape on skewed bins (half the features take 2 bins, the rest
     put 90% of their rows in one): packed at 63 leaves and at 1 (a root
     wave), triple at 42.  Float modes: counts exact and g/h within the
     f32 bound below, and a second launch on the same inputs bit-equal to
     the first (the fixed-point sums); int modes: ``torch.equal``.  Then
     int16 fused at the main shape on the same skewed bins: packed at 63
     leaves and at 1; then the layouts of this slice's paths: packed
     unfused at the bundled phase's 34 physical columns, triple unfused at
     the mixed phase's narrow group, packed fused on GOSS-sparse rows
     (30% of the rows carry weight);
   - K2 (``ops/hist_channels.hist_channels``) at 1,000,000 x 28 x 256 with
     C=128, on uniform and on skewed bins (90% of every feature's rows in
     one bin), and at 3,001 x 5 x 64 with C=256, within the f32 bound, and
     two launches on the same inputs bit-equal;
3. small-input reference: 3 rounds on 20,000 rows trained on the card and
   on the CPU (plain kernels) must agree, in 2xbf16 and in int16 with
   bagging;
4. main path: the 1,000,000 x 28 HIGGS-shaped data (the headline
   configuration of bench.py, generated from seed 0) is binned through the
   native g++ library, which must have loaded, and once more through the
   numpy path, which must give the same bytes (both timed); then
   ``lightgbm_tpu_torch.train`` on it, 5 rounds, 255 leaves; K1 must have
   launched at least once per wave; train logloss must fall every round
   and AUC exceed 0.7; the same training once more must print the same
   model digest (K1's float sums are repeatable); one more iteration
   under torch.profiler gives the device's busy time by kernel and its
   idle share;
5. quantized main path (bench.py's BENCH_QUANT=int16 leg): the same data
   and Dataset, ``tpu_hist_dtype=int16``, 5 rounds; K1 at least once per
   wave, logloss falling every round, final train AUC within 1e-3 of
   phase 4's; one profiled iteration;
6. the triple layout's path: the wave grower with ``packed=False`` (42
   leaves a wave) grows one int16 tree on phase 5's next inputs, identical
   to the packed grower's at the same capacity; and K2's path:
   ``hist_channels_fm`` builds the root histogram of the same inputs,
   whose per-feature sums must be the totals;
7. int8 with ``bagging_fraction=0.8, bagging_freq=1``, 5 rounds: K1 at
   least once per wave, final train AUC within 1e-2 of phase 4's; then
   GOSS on the same Dataset (``boosting=goss``, top_rate 0.2, other_rate
   0.1, learning_rate 0.1), 14 rounds so that iterations 10-13 sample:
   s/iter unsampled and sampled, the kept share of each sampled
   iteration (0.30 within 6 binomial standard deviations), the sample
   mask on the card, logloss falling every round;
8. predict: phase 4's booster (5 trees, 255 leaves) predicts all
   1,000,000 rows, which takes the device forest walk (5,000,000 rows x
   trees, above the 2,000,000 threshold; its call count must rise), held
   against the host walk on the first 20,000 rows at atol 1e-4 on raw
   scores; then ``Booster(model_str=...)`` of its model text on the card
   through the model-derived bin space at atol 1e-6; leaf indices equal
   to the host walk's; prediction early stop (freq 1, margin 1.5) within
   1e-6 of the host's.  Times by CUDA events (the whole call and the
   forest walk alone), rows/s, and the card's kernel launches and copies
   in one call (torch.profiler);
9. CLI: a 200,000 x 28 HIGGS-shaped TSV (label in column 0) trains 5
   trees of 255 leaves with ``python -m lightgbm_tpu_torch task=train`` on
   the card and predicts with ``task=predict``, both as subprocesses that
   must exit 0; ``task=predict`` must go through a ``PredictorSession``
   (``LGBM_TPU_PREDICT_MIN_WORK=0``) and its output equal
   ``Booster(model_file=...).predict`` (its stacked-forest walk) at 1e-10;
10. categorical + EFB: 1,000,000 rows of the headline columns, 4
   Zipf-skewed categorical columns (8, 32, 100, 250 categories) and 32
   mutually exclusive sparse count columns (each row non-zero in one), 5
   rounds of 255 leaves with those 4 declared categorical: at most 36
   physical columns, K1's unfused packed layout launched, train AUC >
   0.7, the profiled iteration, device predict of the 1,000,000 rows
   within 1e-4 of the host walk on the first 20,000 with equal leaves;
11. mixed width: the same data and one 1,000-category column with
   ``max_bin_by_feature`` 1023 (255 elsewhere), 5 rounds, trained twice:
   both the narrow (K1, triple) and the wide (side-pass) group non-empty,
   K1's triple layout and the side-pass launched, equal model digests;
   the side-pass's time per wave by CUDA events;
12. multiclass: 581,012 x 54 Covertype-shaped rows (10 continuous
   columns, a 4-column wilderness and a 40-column soil one-hot that EFB
   bundles, 7 classes with Covertype's shares; seed 3): K1 packed
   unfused at the bundled column count against its plain version;
   ``objective=multiclass, num_class=7``, 255 leaves, 5 rounds (35 trees),
   trained twice on one Dataset with one digest, multi_logloss falling
   every round; one profiled iteration; device prediction of every row,
   probabilities within 1e-6 of the host walk on the first 20,000; 2
   rounds of multiclassova;
13. lambdarank: 2,270,296 x 136 MSLR-WEB30K-shaped rows (bench.py's
   ``_rank_data``: query sizes from ``ops/rank.py mslr_like_sizes``,
   grades 0-4): K1 packed fused at F = 136 against its plain version;
   bench.py ``_run_rank``'s parameters (255 leaves, min_data_in_leaf 50,
   min_sum_hessian_in_leaf 5, eval_at 10), 5 rounds, trained twice with
   one digest; one profiled iteration; the pair pass's ms per iteration by
   CUDA events against its bound (``rank_pair_cost``); the device NDCG@10
   within 1e-6 of the host loop; peak device memory;
14. regression: the headline 1,000,000 x 28 rows with a seeded noisy
   blend for the label and seeded positive sample weights, ``regression``
   and ``quantile`` (alpha 0.9: the host leaf refit, its time broken out),
   5 rounds each, each trained twice with one digest, the metric falling
   every round.

The serial grower, the rest of the training API and LibSVM input (run
after phase 8 on phase 4's Dataset, and after phase 9), labelled (a)-(f):

(a) the serial grower on phase 4's rows: ``forcedsplits_filename`` (the
   fixture ``tests/fixtures/forced_splits.json``: features 25, 10, 4),
   ``cegb_penalty_split`` 0.02, a coupled CEGB penalty on every column and
   a lazy one on four, ``feature_fraction_bynode`` 0.5; 255 leaves, 3
   rounds, trained twice with one digest; the forced BFS prefix in every
   tree; one K2 launch (C = 32) per leaf histogram and no K1; one profiled
   iteration;
(b) the same rows at ``max_bin=1023``: every column wider than 256 bins,
   so the serial grower's fixed-point wide histogram takes every leaf; 3
   rounds twice, one digest; its time at the root leaf by CUDA events,
   beside the mixed-width side-pass in the same role; one profiled
   iteration; then CEGB without lazy penalties (split 0.02, coupled 0.5
   on every column) on the wave grower, 3 rounds twice, one digest;
(c) K2 at C = 32 (the serial grower's channel group) against its plain
   version at 1,000,000 x 28 x 256 in phase 2, bit-equal launches, with
   its byte bound for the 32 channels read and the 3 used;
(d) the training API on phase 4's rows at 31 leaves: 10 rounds against 5
   saved and 5 more through ``init_model`` from the file (probabilities
   within 1e-4), init scores from the 5-round model's raw scores (plus 5
   rounds within 1e-4 in raw score of the continued model), a numpy
   logloss ``fobj`` with an AUC ``feval``, ``learning_rates`` as a
   decaying list, ``cv`` (3 folds, 5 rounds); each run twice with one
   digest (``cv``: equal results), wall seconds;
(e) sparse input: a 1,000,000 x 5,000 CSR with 8 stored entries a row
   (``tests/test_sparse.py``'s wide shape and parameters) binned without
   densifying (host seconds, tracemalloc peak), 3 rounds on the grower the
   JAX package's rule picks, prediction from the CSR on the card (the
   used columns gathered; within 1e-6 of the host walk on 20,000 rows);
(f) the CLI on LibSVM files, in this process (``app.main``; phase 9 runs
   it as a subprocess): a 200,000-row MSLR-shaped file with ``qid:``
   through ``objective=lambdarank`` gives the same trees with and without
   ``two_round``; a binary file with ``.weight`` and ``.init`` sidecars
   and ``save_binary=true``; ``input_model`` continuation; training from
   the ``<data>.bin`` file gives the text's trees.

The ninth slice's phases, run after phase 8 on phase 4's Dataset and
booster (TreeSHAP's multiclass case in phase 12):

15. DART (``drop_rate`` 0.1, ``skip_drop`` 0, ``drop_seed`` 37: trees
   dropped in most iterations) 5 rounds twice, one digest, train AUC >
   0.7, the stacked-forest prediction of every row within 1e-4 of the
   host walk after the rescales; ``xgboost_dart_mode`` 3 rounds;
16. RF (``bagging_fraction`` 0.632 every iteration, ``feature_fraction``
   0.8) 5 rounds twice, one digest, the prediction the average of the
   trees;
17. TreeSHAP: ``pred_contrib`` on 100,000 rows of the main path's model
   (6 trees: phase 4's profiled iteration added one) and on 5,000 of the
   multiclass one (42 trees, paths ~3x as deep) through the batched
   torch pass (``explain/``): the call and the pass by CUDA events, rows/s,
   P and L, the bound from ``ops/treeshap.py shap_cost`` (FP32 peak, the
   slots the pass runs), local accuracy within 1e-4, the f64 host
   recursion within 1e-5 on 100 rows (all the main path's trees, the
   multiclass model's first iteration) and on 50 (the multiclass model's
   last iteration);
18. checkpoint and resume: a crash (an injected ``raise`` at the device
   step of iteration 7) of a 10-round 2xbf16 + bagging run with a
   checkpoint every 3 rounds, resumed with the same directory: model text
   byte-equal to the uninterrupted run's; the same for DART (6 rounds,
   crash at 4) and int16 + bagging; the time to write and to resume one
   checkpoint;
19. the device guard: a transient fault retried (the main path's model),
   a fatal one under ``tpu_on_device_error=abort`` raising
   DeviceWedgedError with the boundary checkpoint left;
20. the oracles: ``tpu_batched_split_apply=false`` and
   ``tpu_fused_grad=false`` grow the main path's trees; ``tpu_wave_overlap``
   on and its ``serial`` oracle grow one model; s/iter of each;
21. ``task=convert_model``: the CLI writes the main path's model as C,
   the host C compiler builds it, and it scores 1,000 rows within 1e-10 of
   ``predict(raw_score=True)``.

The tenth slice's phases, serving on the card, run last (the arena's
tenants come from phases 12 and 14); the served model is phase 4's
Dataset trained 100 rounds at 255 leaves (2xbf16) right after phase 21,
saved to a file and served from it, with its 50-iteration cut:

22. set-up: ``task=predict``'s two routes on all 1M rows, timed
   (``Booster.predict`` and ``PredictorSession.predict``, within 1e-6 of
   each other); ``PredictorSession(model_file)``: ``warmup()`` of the 11
   pow2 buckets up to 1,024; 100,000 rows within 1e-6 of
   ``Booster.predict`` and 2,000 of them within 1e-6 of the f64 host
   walk (raw); p50/p99
   of 200 sync calls at 1, 8, 64, 256 and 1,024 rows (host clock, result
   on the host) and rows/s;
23. ``run_serve``'s stack in process (a registry of 2 replicas on
   ``cuda:0``, the arena attached, ``PredictServer`` on a free port): 8
   client threads x 100 requests of 1-256 rows with mixed priorities,
   every reply within 1e-6 of ``Booster.predict``; client p50/p99, served
   and shed, occupancy, pad waste; ``POST /explain`` of 64 rows summing to
   the raw score within 1e-4; a hot swap of ``default`` to the
   50-iteration cut under traffic (no failed request, every reply equal
   to the version it names), then a rollback;
24. the arena: the served model, phase 12's multiclass model and phase
   14's weighted regression model; mixed-tenant batches (at least one
   cross-model) bit-equal to each tenant's solo session on the card; a
   byte budget one byte short of the three evicts one tenant, which its
   next request re-admits, bit-equal again;
25. device faults over HTTP: ``serve_replica_0`` wedged (every reply from
   r1, r0's breaker open and unhealthy on /health; closed again once the
   fault stops), one ``serve_device`` fault (a 503 with Retry-After, the
   replica degraded, the sibling answering, the re-probe recovering); no
   reply from the host (every 200 bit-equal to a solo session's);
26. ``python -m lightgbm_tpu_torch task=serve input_model=<file>
   tpu_serve_port=<free>``: /health "ok", ``POST /predict`` of 1,000 rows
   within 1e-6 of ``Booster.predict``, SIGINT, exit 0 within 10 s.
   Serving launches no hand kernel: the phases zero the counts and print
   them (0) beside the forest walks they ran, then their total seconds and
   a ``{"serving": ...}`` line.

The eleventh slice's phases run after phase (d), while the headline rows
live (lines start ``API``, ``obs`` and ``drift``, then ``phases 27-28``):

27. the Python API: ``LGBMClassifier().fit`` on the 1M x 28 rows, 5 rounds
   at 255 leaves, equal (one digest) to ``train`` on the parameters it
   passes; pickle and ``deepcopy`` round trips bit-equal on 100,000 rows;
   ``trees_to_dataframe`` one row a node; ``plot_importance`` and
   ``plot_tree`` to files (the digraph source where graphviz's ``dot`` is
   missing); a 200,000-row DataFrame with a category column trained,
   predicted and its categories kept through the model text;
28. observability: the main path with every plane off, with each of
   ``tpu_telemetry``, ``tpu_health=strict``, ``tpu_profile``, ``tpu_trace``
   alone and all together, and off again: the main path's trees every
   time, 5 ``iteration`` events, K1 held against ``hist_wave_cost``'s
   bound in ``kernel_profile`` events, the memory peak within the run's
   ``max_memory_allocated``, s/iter by plane, and no more
   ``torch.cuda.synchronize`` calls with the planes off again than in the
   first plain run; the serial grower (K2) under ``tpu_health=strict``;
   the phase-22 model served with drift monitoring (its quality sidecar):
   no breach on in-distribution rows, a breach on shifted ones, ``/drift``
   and ``/debug/flight`` answering.

The twelfth slice's phase runs last, on the phase-22 model (lines start
``refit``, ``CLI task=refit``, ``online``, ``online continue``, then
``phase 29`` and a ``{"refit": ...}`` line):

29. (a) ``Booster.refit`` on 1,000,000 fresh HIGGS-shaped rows at decay
   0.9, on the card twice and through the host oracle: leaves and
   100,000 rows' predictions within 1e-6 of the oracle, the two card
   refits' model texts byte-equal, the leaf walk and the steps timed by
   CUDA events against their byte bounds, the ``refit`` events; (b)
   ``task=refit`` of phase 9's model on its rows with flipped labels,
   within 1e-10 of ``Booster.refit``; (c) ``run_online`` over HTTP (2
   replicas on ``cuda:0``) on a 60,000-line label stream: 3 versions
   pushed, none rejected or failed, no request lost under a client
   thread, each reply within 1e-6 of its version's ``Booster.predict``,
   ``/metrics``'s ``tpu_online_*`` equal to ``stats()``, the quality
   windows armed, an ``OnlineLoop(push=None)`` replay byte-equal; a
   40,000-line run with one ``online_refit`` fault: 1 failed, the base
   kept; (d) ``tpu_online_mode=continue``: 10 trees on a 50,000-row
   window, K1 counted, thresholds the base model's, logloss down.

The thirteenth slice's phases: 31 runs after phase 28, while the
headline rows live (lines ``parallel``, ``K1 ... (one rank's rows)``,
``K2 ... (one rank's feature block)``, ``phase 31``); 30 runs after 29,
on the phase-22 model (lines ``AOT``, ``phase 30``); then ``{"aot": ...}``
and ``{"parallel": ...}`` lines:

30. cold restarts of a served model: two cold subprocesses of this
   script (``--aot-child``) serve the phase-22 model from its file with
   the serving store (``tpu_serve_aot_dir``) in one directory, the first
   on an empty store (a miss: packed from the model, entry written), the
   second on the warm store (a hit); each captures one CUDA graph per
   bucket at warm-up (11 buckets, 1 to 1,024 rows) and prints request
   #1's ms against the steady p99 at its bucket, the captures on the
   request path (must be 0), sync p50/p99 for every bucket with the graph
   and with the session's eager walk beside it, and that the two answer
   bit-equal at every bucket; the two processes' scores must be equal;
   then a truncated entry in this process: one ``aot_fallback``, the same
   scores;
31. the learners across ranks: two ranks
   (``lightgbm_tpu_torch/tools/dist_check.py``, one process each, both
   on ``cuda:0``, gloo through the host) on the headline 1M x 28 rows with
   phase 4's parameters, ``tree_learner=data`` in 2xbf16 and int16 (K1
   unfused on each rank's 500,000 rows; 5 rounds), ``voting`` and
   ``feature`` (K2 at C = 32; 3 rounds since phases 32-33 joined the
   script): s/iter, the collectives' calls and bytes,
   K1/K2 launches, each rank's digest (the ranks must agree; int16's
   trees must be phase 5's, legacy digest 614716ef924a0d6e; 2xbf16's
   equality with phase 4's is printed); world size 1 through the same
   code in this process; K1 unfused at one rank's rows (2xbf16, int16),
   its exact int16 sums, and K2 at one rank's 14-column block against
   their plain versions.

The ingestion and fleet phases run after 31, once the headline rows are
freed (lines ``ingest``, ``ingested``, ``fleet``, ``phase 32``, ``phase
33``, then an ``{"ingest": ..., "fleet": ...}`` line):

32. out-of-core ingestion at HIGGS's size: an 11,000,000 x 28
   HIGGS-shaped ``.npy`` (``higgs_like``, seed 0; 2.46 GB of f64) and its
   ``.y.npy`` sidecar streamed through ``ingest.open_source`` in 65,536-row
   chunks into a memmap-backed bin matrix: each pass's seconds and rows/s,
   the host peak (tracemalloc) against the raw matrix (under a quarter of
   it); phase 4's parameters for 5 rounds on the card (K1 once a wave or
   more, train AUC > 0.7); K1 at 11M rows against its plain version,
   ``index_add_`` and its bound.  Guard 1: the first 1,000,000 rows with
   ``bin_construct_sample_cnt`` at the row count, streamed, have
   ``from_matrix``'s bins, mappers and labels and train its trees; guard 2:
   ``task=train tpu_ingest=true`` on a 200,000 x 28 TSV (seed 2) trains the
   trees of ``task=train``.  The files are deleted;
33. the fleet on the one card, on that TSV with phase 4's parameters and
   ``tpu_ingest=true``: (a) ``tpu_fleet=2`` over the host transport, 5
   rounds: the elected model and each rank's copy have the
   single-process CLI's trees, and no ``member_dead``, ``resize`` or
   ``fleet_stall``; (b) 3 ranks, 6 rounds, a checkpoint every 2,
   ``LGBM_TPU_FAULTS=fleet_die:raise@iter=3`` on rank 1: rank 1 exits
   137, the fleet 0, ``member_dead`` and ``resize`` in the events, the
   never-failed single-process model's trees; (c) ``tpu_fleet=2`` with
   ``auto``, the device transport on the card (sharded ingest, the
   data-parallel learner over ``torch.distributed``, both ranks on
   ``cuda:0``) in int16: every rank's trees the single-process int16
   model's.  Each rank's s/iter, start-up seconds and K1 launches (from
   its ``rank<N>.stats.json``).

The fifteenth slice's phases run after 28, while the headline rows and
phase 4's booster live (lines ``C ABI``, ``board``, ``xprof``,
``reconciliation``, ``report CLI``, ``phase 34``, ``phase 35``, then a
``{"capi_abi": ..., "board_xprof": ...}`` line):

34. the C ABI: a C program compiled with gcc against the port's loadable
   library (``native.capi_abi_lib``: ``native/capi_abi.c``, embedding
   CPython, built into ``build/``) reads the headline rows from raw files,
   trains phase 4's parameters through ``LGBM_DatasetCreateFromMat`` and
   5 ``LGBM_BoosterUpdateOneIter`` calls on the card, predicts every row
   through ``LGBM_BoosterPredictForMat`` and saves the model: its trees
   phase 4's (legacy digest 28b298b3082595ad), its probabilities within
   1e-6 of ``Booster.predict`` over the same trees, its K1 launches
   (printed by the child's embedded interpreter) at least one a wave;
35. the train board and the profiler window: phase 4's training with the
   board alone (its cost a round); then with the board, telemetry,
   profile mode and ``tpu_xprof`` (3 iterations): ``/metrics`` and
   ``/progress`` scraped at iteration 2, phase 4's trees, K1's
   ``kernel_measured`` row (``torch.profiler``'s device time of the
   window's launches against ``hist_wave_cost``'s bound) beside profile
   mode's CUDA-event time of the same launches, the ``reconciliation``
   units, ``python -m lightgbm_tpu_torch.obs.report`` over the sink; the
   serial grower (31 leaves) 3 rounds with a 1-iteration window: K2's
   row.  The window opens after two iterations, as the JAX package's
   does, so 5 rounds record iterations 2-4.  Phase 31's 2xbf16 data leg
   runs telemetry (with no metric), so its ranks exchange their phase
   walls: the skew table is printed.

Every path (each training phase, the triple grower, K2's path) sets all
launch counts to 0 just before it and reads them just after; K1 counts
its launches in all, by layout and by sibling form (fused or not); K2 its
launches, the serial grower's wide histogram its calls.  Each training phase prints a digest
of its model text (equal digests, equal trees).  Prints a
``{"kernels": [...]}`` line (``launches`` from each kernel's path,
``training_path_launches`` over the three training phases,
``check_launches`` from phase 2, ``skewed`` the skewed-bin cases' times
and errors, K1's launches on the DART, RF, overlap, resume, estimator,
observability, online-continue, data-parallel, ingest and fleet paths
(per rank), at the ingested 11M rows, on the C ABI's and the window's
paths (the window's launches by the profiler and by CUDA events), K2's
on the serial grower under health, on the voting and feature paths (per
rank) and under the window), a
``{"pair_pass": {...}}`` line (the lambdarank pair pass, torch, with its
bound), a ``{"treeshap": [...]}`` line (the TreeSHAP pass, torch, with its
``shap_cost`` bound), the ``{"serving": ...}``, ``{"refit": ...}``,
``{"aot": ...}``, ``{"parallel": ...}``, ``{"ingest": ...,
"fleet": ...}`` and ``{"capi_abi": ..., "board_xprof": ...}`` lines, the
card's name and
power limit and, last, the
device line
``{"ok": true, "device": {...}}``.  Imports no jax and nothing of
lightgbm_tpu.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 25
# f32 sums of the same values in another order: per cell the difference
# is bounded by a few ulps of the sum of magnitudes in that cell
REL_TOL = 1e-5
# ... for a cell of up to this many rows.  The rounding of an f32 sum of n
# terms grows as sqrt(n) (the plain version's own included), so a cell of
# n rows more is held to sqrt(n / ROWS_AT_REL_TOL) times REL_TOL: ~11
# standard deviations of the difference of two summation orders at any n
ROWS_AT_REL_TOL = 1000
DEV = "cuda"
MAIN_ROWS = 1_000_000            # the headline configuration's rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def higgs_like(rows: int, seed: int = 0):
    """bench.py's synthetic HIGGS-shaped binary data (28 features)."""
    rng = np.random.default_rng(seed)
    n_informative = 8
    X = rng.normal(size=(rows, 28)).astype(np.float32)
    w = rng.normal(size=n_informative)
    logit = X[:, :n_informative] @ w + 0.5 * X[:, 0] * X[:, 1]
    y = (logit + rng.logistic(size=rows) > 0).astype(np.float64)
    return X.astype(np.float64), y


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_name(symbol: str) -> str:
    """The unqualified name of a mangled kernel symbol
    (``_ZN12_GLOBAL__N_120hist_wave_float_rowsE...`` ->
    ``hist_wave_float_rows``); other strings pass through."""
    if not symbol.startswith("_Z"):
        return symbol
    i = 3 if symbol.startswith("_ZN") else 2
    name = symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        name, i = symbol[j:j + n], j + n
    return name


def sass_census(lib) -> dict:
    """Per kernel of the built library, the count of each atomic,
    reduction and warp-match opcode in its SASS (``cuobjdump`` from the
    CUDA toolkit): shared-memory atomics (ATOMS.*), global atomics and
    reductions (ATOMG.*, ATOM.*, RED.*, REDG.*), warp reductions (REDUX.*)
    and MATCH.*.  Shows
    whether an add compiled to one instruction or to a compare-and-swap
    loop, and which instruction a global reduction became."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=120).stdout
    except OSError as err:
        return {"cuobjdump": f"unavailable ({err})"}
    census, fn = {}, "?"
    for line in out.splitlines():
        if "Function :" in line:
            fn = kernel_name(line.split("Function :")[1].strip())
            continue
        for tok in line.split():
            if tok.startswith(("ATOMS.", "ATOMG.", "ATOM.", "RED.", "REDG.",
                               "REDUX", "MATCH.")):
                ops = census.setdefault(fn, {})
                ops[tok] = ops.get(tok, 0) + 1
    return census


def sass_atomics(census: dict) -> dict:
    """Count of each shared-memory atomic opcode (ATOMS.*) over every
    kernel of ``sass_census``'s result."""
    if "cuobjdump" in census:
        return census
    counts = {}
    for ops in census.values():
        for op, n in ops.items():
            if op.startswith("ATOMS."):
                counts[op] = counts.get(op, 0) + n
    return counts


def peaks():
    """The H100's (memory bytes/s, f32 operations/s, f64 operations/s),
    the data sheet's, as profile mode holds kernels against them
    (``lightgbm_tpu_torch/obs/profile.py``)."""
    from lightgbm_tpu_torch.obs import profile
    return (profile.H100_HBM_BYTES_PER_S, profile.H100_F32_OPS_PER_S,
            profile.H100_F64_OPS_PER_S)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger."""
    hbm, f32, _ = peaks()
    bytes_ms = n_bytes / hbm * 1e3
    ops_ms = n_ops / f32 * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=int(n_bytes), ops=int(n_ops))


def flat(x):
    """The tensors of a kernel result, in order."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in flat(part)]


def wave_inputs(N, F, B, leaves, fused, mode, packed, seed, leaf_hi=None,
                skew=False, keep=None):
    """Random K1 inputs as the wave grower forms them: bins over [0, B),
    g/h/count vectors (stochastic-rounded integers under a bag mask in the
    int modes), leaf ids over 2*leaves ids drawn from [0, leaf_hi) of which
    the first half are pending, the layout's slot map and, fused, a parent
    histogram in that layout.  ``skew``: the first half of the features
    take two bins (0 and B-1), the rest put 90% of their rows in one bin
    and spread the others over [0, B).  ``keep``: the share of rows that
    carry weight, the rest masked out as GOSS masks them (float modes)."""
    import torch
    from lightgbm_tpu_torch.ops.quant import QUANT_MODES, QUANT_QMAX
    g = torch.Generator(device=DEV).manual_seed(seed)
    dev = DEV
    bins = torch.randint(0, B, (F, N), generator=g, device=dev,
                         dtype=torch.int32)
    if skew:
        half = F // 2
        bins[:half] = torch.randint(0, 2, (half, N), generator=g, device=dev,
                                    dtype=torch.int32) * (B - 1)
        hot = torch.rand((F - half, N), generator=g, device=dev) < 0.9
        hot_bin = torch.arange(half, F, device=dev,
                               dtype=torch.int32)[:, None] * 37 % B
        bins[half:] = torch.where(hot, hot_bin, bins[half:])
    bins = bins.to(torch.uint8)
    if mode in QUANT_MODES:
        q = int(QUANT_QMAX[mode])
        cv = (torch.rand(N, generator=g, device=dev) < 0.9).float()
        gv = torch.randint(-q, q + 1, (N,), generator=g, device=dev).float() * cv
        hv = torch.randint(0, q + 1, (N,), generator=g, device=dev).float() * cv
    else:
        cv = torch.ones(N, device=dev)
        gv = torch.randn(N, generator=g, device=dev)
        hv = torch.rand(N, generator=g, device=dev) * 0.25
        if keep is not None:
            cv = (torch.rand(N, generator=g, device=dev) < keep).float()
            gv, hv = gv * cv * 8.0, hv * cv * 8.0
    ids = torch.randperm(leaf_hi or 2 * leaves, generator=g,
                         device=dev)[:2 * leaves]
    leaf = ids[torch.randint(0, 2 * leaves, (N,), generator=g, device=dev)]
    leaf = leaf.int()
    lanes = 2 if packed else 3
    slot = torch.full((128,), -1, dtype=torch.int32, device=dev)
    slot[:lanes * leaves] = ids[:leaves].repeat_interleave(lanes).int()
    parent = None
    if fused:
        pg = torch.randn((F, B, 128), generator=g, device=dev) * 100
        pc = torch.randint(0, 1000, (F, B, 128), generator=g,
                           device=dev).float()
        if mode in QUANT_MODES:
            pg = pg.round()
        parent = (pg, pc) if packed else pg
    return bins, gv, hv, cv, leaf, slot, parent


def check_kernel(hw, N, F, B, leaves, fused, mode, seed, packed=True,
                 leaf_hi=None, skew=False, keep=None):
    """K1 against its plain version on one shape, and in the float modes a
    second launch bit-equal to the first; returns the numbers of the
    kernels line."""
    import torch
    from lightgbm_tpu_torch.ops.quant import QUANT_MODES
    quant = mode in QUANT_MODES
    bins, gv, hv, cv, leaf, slot, parent = wave_inputs(
        N, F, B, leaves, fused, mode, packed, seed, leaf_hi, skew, keep)
    args = (bins, gv, hv, cv, leaf, slot, B)
    kw = dict(highest=mode, packed=packed, parent=parent)
    got = flat(hw.hist_wave(*args, **kw, num_slots=leaves))
    want = flat(hw.hist_wave_plain(*args, **kw))
    torch.cuda.synchronize()
    tag = (f"K1 {mode} {'packed' if packed else 'triple'} "
           f"{'fused' if fused else 'unfused'} N={N} F={F} B={B}"
           f"{f' S={leaves} skewed bins' if skew else ''}"
           f"{f' {keep:.0%} rows kept' if keep else ''}")
    max_err = 0.0
    if not quant:
        again = flat(hw.hist_wave(*args, **kw, num_slots=leaves))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{tag}: two launches on the same inputs "
                                 "differ")
    if quant:
        for g_t, w_t in zip(got, want):
            if not torch.equal(g_t, w_t):
                raise AssertionError(f"{tag}: kernel != plain version")
    else:
        mag = flat(hw.hist_wave_plain(bins, gv.abs(), hv.abs(), cv, leaf,
                                      slot, B, highest=mode, packed=packed))
        # rows in each lane's cell (every row weighs 1 here): its count lane
        lane = torch.arange(128, device=DEV)
        rows = want[1][..., lane // 2] if packed else \
            want[0][..., (lane // 3 * 3 + 2).clamp(max=127)]
        scale = (rows / ROWS_AT_REL_TOL).sqrt().clamp(min=1.0)
        for i, (g_t, w_t) in enumerate(zip(got, want)):
            counts = ([(g_t, w_t)] if packed and i % 2 == 1 else
                      [] if packed else [(g_t[..., 2::3], w_t[..., 2::3])])
            for g_c, w_c in counts:
                if not torch.equal(g_c, w_c):
                    raise AssertionError(f"{tag}: counts differ")
            err = (g_t - w_t).abs()
            lim = REL_TOL * mag[i % len(mag)] * scale + 1e-6
            if fused:
                lim = lim + REL_TOL * w_t.abs()
            if not bool((err <= lim).all()):
                raise AssertionError(f"{tag}: g/h differ beyond the f32 "
                                     f"bound: max err {float(err.max())}")
            max_err = max(max_err, float(err.max()))

    saved = (hw.hist_wave.launches, dict(hw.hist_wave.layout_launches))
    ms = cuda_ms(lambda: hw.hist_wave(*args, **kw, num_slots=leaves))
    plain_ms = cuda_ms(lambda: hw.hist_wave_plain(*args, **kw))
    # timing launches do not count
    hw.hist_wave.launches = saved[0]
    hw.hist_wave.layout_launches.update(saved[1])

    # library yardstick: one index_add_ over the flattened (f, b, slot)
    # index of the rows in a pending slot, values as K1 accumulates them
    lanes = 2 if packed else 3
    pend = slot[0:lanes * leaves:lanes].long()
    r, s = torch.nonzero(leaf.long()[:, None] == pend[None, :],
                         as_tuple=True)
    flat_idx = ((torch.arange(F, device=DEV)[:, None] * B
                 + bins[:, r].long()) * leaves + s[None, :]).reshape(-1)
    if quant:
        src = torch.stack([gv[r], hv[r], cv[r]], 1).long()
    else:
        src = torch.stack([hw.round_values(gv[r], mode),
                           hw.round_values(hv[r], mode), cv[r]], 1)
    src = src[None].expand(F, -1, -1).reshape(-1, 3).contiguous()
    out = torch.zeros((F * B * leaves, 3), dtype=src.dtype, device=DEV)
    library_ms = cuda_ms(lambda: out.index_add_(0, flat_idx, src))

    # K1's bytes and the adds these inputs need (the rows in a pending
    # slot), as profile mode counts them
    n_ops, n_bytes = hw.hist_wave_cost(N, F, B, int(r.numel()),
                                       packed=packed, fused=fused,
                                       quant=quant)
    res = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(n_bytes, n_ops))
    return tag, res


def print_check(k, kind, card):
    """One kernel-vs-plain result line."""
    print(f"{k['tag']}: max_abs_err {k['max_abs_err']:.3g}, kernel "
          f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, index_add_ "
          f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
          f"{k['bound_by']} ({k['bytes']} bytes, {k['ops']} adds) "
          f"[{kind}, {card}]", flush=True)


def phase_check(hw, res, key, N, F, leaves, fused, seed, kind, card):
    """K1 (2xbf16, packed) against its plain version at a training phase's
    shape, recorded in ``res`` under ``key`` like the phase-2 cases."""
    n0 = hw.hist_wave.launches
    tag, res[key] = check_kernel(hw, N, F, 256, leaves, fused, "2xbf16", seed)
    res[key].update(tag=tag, check_launches=hw.hist_wave.launches - n0)
    print_check(res[key], kind, card)


def check_channels(hc, N, F, B, C, seed, skew=False):
    """K2 against its plain version on one shape, and two launches on the
    same inputs bit-equal (every cell has one owner, the chunks are summed
    in order); the library yardstick is one ``index_add_`` over the
    flattened (feature, bin) index with its expanded [F*N, C] source built
    outside the timed region.  ``skew``: 90% of every feature's rows in
    one bin."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    bins = torch.randint(0, B, (F, N), generator=g, device=DEV,
                         dtype=torch.int32)
    if skew:
        hot = torch.rand((F, N), generator=g, device=DEV) < 0.9
        hot_bin = torch.arange(F, device=DEV, dtype=torch.int32)[:, None]
        bins = torch.where(hot, hot_bin * 37 % B, bins)
    bins = bins.to(torch.uint8)
    gh = torch.randn((N, C), generator=g, device=DEV)
    got = hc.hist_channels(bins, gh, B)
    again = hc.hist_channels(bins, gh, B)
    want = hc.hist_channels_plain(bins, gh, B)
    mag = hc.hist_channels_plain(bins, gh.abs(), B)
    torch.cuda.synchronize()
    tag = f"K2 N={N} F={F} B={B} C={C}{' skewed bins' if skew else ''}"
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: two launches differ")
    err = (got - want).abs()
    if not bool((err <= REL_TOL * mag + 1e-6).all()):
        raise AssertionError(f"{tag}: beyond the f32 bound: max err "
                             f"{float(err.max())}")
    launches0 = hc.hist_channels.launches
    ms = cuda_ms(lambda: hc.hist_channels(bins, gh, B))
    plain_ms = cuda_ms(lambda: hc.hist_channels_plain(bins, gh, B))
    hc.hist_channels.launches = launches0
    del mag, want
    flat_idx = (torch.arange(F, device=DEV)[:, None] * B
                + bins.long()).reshape(-1)
    src = gh[None].expand(F, -1, -1).reshape(F * N, C)
    out = torch.zeros((F * B, C), device=DEV)
    library_ms = cuda_ms(lambda: out.index_add_(0, flat_idx, src))
    del src, flat_idx, out
    torch.cuda.empty_cache()
    n_ops, n_bytes = hc.hist_channels_cost(N, F, B, C)  # every bin < B
    res = dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(n_bytes, n_ops))
    return tag, res


def small_reference(lt):
    """3 rounds on 20,000 rows: the card (kernels) against the CPU (plain
    versions), in 2xbf16 and in int16 with bagging."""
    X, y = higgs_like(20_000, seed=1)
    base = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
            "min_data_in_leaf": 100, "verbose": -1,
            "metric": ["binary_logloss", "auc"]}
    for extra in ({}, {"tpu_hist_dtype": "int16", "bagging_fraction": 0.8,
                       "bagging_freq": 1}):
        params = {**base, **extra}
        res = {}
        for dev in (DEV, "cpu"):
            ev = {}
            ds = lt.Dataset(X, label=y)
            bst = lt.train(params, ds, 3, valid_sets=[ds],
                           valid_names=["train"], evals_result=ev, device=dev)
            res[dev] = (bst, ev["train"])
        same = sum(
            np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold, b.threshold)
            for a, b in zip(res[DEV][0]._gbdt.models,
                            res["cpu"][0]._gbdt.models))
        d_loss = abs(res[DEV][1]["binary_logloss"][-1]
                     - res["cpu"][1]["binary_logloss"][-1])
        d_auc = abs(res[DEV][1]["auc"][-1] - res["cpu"][1]["auc"][-1])
        print(f"small reference {extra or '2xbf16'}: {same}/3 trees "
              f"identical card vs CPU, |d logloss| {d_loss:.3g}, |d auc| "
              f"{d_auc:.3g}", flush=True)
        if d_loss > 1e-3 or d_auc > 1e-3:
            raise AssertionError("card and CPU training disagree on the "
                                 "small input")


def profile_iteration(bst, iter_ms, kind, card):
    """One more boosting iteration under torch.profiler, its CUDA activity
    only: where the iteration's time goes on the card (the phase's counts
    are read before this).  The profiler slows the host side many times
    over, so the idle share is taken against ``iter_ms``, the median
    unprofiled iteration.  The CPU activity is not recorded: it doubled
    a profiled iteration's wall (33-41 s for the serial grower's against
    18-20, NVIDIA H100 80GB HBM3 at 700 W) for no number this reads.  Returns (device busy ms, K1 ms,
    idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        bst.update()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0 and ev.key and not ev.key.startswith(
                ("ProfilerStep", "cudaDeviceSynchronize")):
            rows.append((dev_us, ev.count, ev.key))
    kernels = [r for r in rows if not r[2].startswith("aten::")]
    busy = sum(r[0] for r in kernels) / 1e3
    k1 = sum(r[0] for r in kernels if "hist_wave" in r[2]) / 1e3
    k2 = sum(r[0] for r in kernels if "hist_channels" in r[2]) / 1e3
    idle = max(0.0, 1 - busy / iter_ms)
    print(f"profiled iteration: device kernels {busy:.3f} ms (K1 "
          f"{k1:.3f} ms, K2 {k2:.3f} ms); unprofiled iteration {iter_ms:.3f} ms -> device "
          f"idle share {idle:.3f} (wall with the profiler on {wall_ms:.1f} "
          f"ms) [{kind}, {card}]", flush=True)
    for dev_us, count, key in sorted(kernels, reverse=True)[:8]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}", flush=True)
    return busy, k1, idle


def reset_counts(hw, hc):
    """Every kernel's launch count to 0, and the calls of the side-pass and
    of the serial grower's wide-column histogram."""
    from lightgbm_tpu_torch.core.histogram import (hist_fixed_point,
                                                   hist_wave_side)
    hw.hist_wave.launches = 0
    hw.hist_wave.layout_launches.update(packed=0, triple=0)
    hw.hist_wave.sibling_launches.update(fused=0, unfused=0)
    hc.hist_channels.launches = 0
    hist_wave_side.calls = 0
    hist_fixed_point.calls = 0


def read_counts(hw, hc) -> dict:
    """Every kernel's launch count: K1 in all, by layout and by sibling
    form, K2; and the calls of the side-pass and of the wide histogram."""
    from lightgbm_tpu_torch.core.histogram import (hist_fixed_point,
                                                   hist_wave_side)
    return {"k1": hw.hist_wave.launches,
            "k1_packed": hw.hist_wave.layout_launches["packed"],
            "k1_triple": hw.hist_wave.layout_launches["triple"],
            "k1_fused": hw.hist_wave.sibling_launches["fused"],
            "k1_unfused": hw.hist_wave.sibling_launches["unfused"],
            "k2": hc.hist_channels.launches,
            "side_pass": hist_wave_side.calls,
            "wide_hist": hist_fixed_point.calls}


def train_phase(lt, hw, hc, name, params, ds, kind, card, rounds=5,
                callbacks=None, layout="k1_packed"):
    """One training phase on the card with every launch count set to 0
    just before and read just after; checks one launch of ``layout`` (a
    ``read_counts`` key: K1's layouts per wave, or, on the serial grower,
    ``k2`` / ``wide_hist`` per leaf histogram) or more per wave.  Returns (booster, counts, the training set's metric
    curves by name, median ms/iter)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    reset_counts(hw, hc)
    ev = {}
    bst = lt.train(params, ds, num_boost_round=rounds, valid_sets=[ds],
                   valid_names=["train"], evals_result=ev, device=DEV,
                   callbacks=callbacks)
    counts = read_counts(hw, hc)
    launches = counts[layout]
    gb = bst._gbdt
    waves = [w for w, _ in gb.wave_stats]
    rows = [r for _, r in gb.wave_stats]
    if len(gb.models) != rounds * gb.num_tpi:
        raise AssertionError(f"{name}: trained {len(gb.models)} trees, "
                             f"expected {rounds * gb.num_tpi}")
    if launches < sum(waves) or launches == 0:
        raise AssertionError(f"{name}: {layout} launched {launches} times "
                             f"for {sum(waves)} waves")
    curves = ev["train"]
    per_iter = gb.iter_seconds[1:]
    print(f"{name}: leaves/tree {[t.num_leaves for t in gb.models]}, "
          f"waves/tree {waves}, rows histogrammed/tree {rows}, "
          f"launches {counts} [{kind}, {card}]", flush=True)
    print(f"{name}: s/iter after the first {per_iter} (median "
          f"{float(np.median(per_iter)):.4f}), first {gb.iter_seconds[0]:.4f};"
          f" peak device memory {torch.cuda.max_memory_allocated()} bytes "
          f"[{kind}, {card}]", flush=True)
    print(f"{name}: train {dict(curves)}; model digest {model_digest(bst)}"
          f" (under the earlier parameter-block rule "
          f"{legacy_digest(bst)})", flush=True)
    return bst, counts, curves, float(np.median(per_iter)) * 1e3


def goss_phase(lt, hw, hc, params, ds, kind, card):
    """GOSS on the main path's Dataset, 14 rounds: iterations 10-13 sample
    (learning_rate 0.1).  The kept share of each sampled iteration is read
    from the sample mask, which must lie on the card; it must be within 6
    binomial standard deviations of (top_k + other_k) / N.  Returns the
    phase's counts."""
    import torch
    N = ds.num_data()
    top_k, other_k = int(N * 0.2), int(N * 0.1)
    shares, devices = [], set()

    def record(env):
        mask = env.model._gbdt._bag_mask
        devices.add(mask.device.type)
        shares.append(float(mask.mean()))
    rounds = 14
    bst, counts, curves, _ = train_phase(
        lt, hw, hc, "GOSS path", {**params, "boosting": "goss",
                                  "top_rate": 0.2, "other_rate": 0.1},
        ds, kind, card, rounds=rounds, callbacks=[record])
    loss = curves["binary_logloss"]
    gb = bst._gbdt
    unsampled, sampled = gb.iter_seconds[1:10], gb.iter_seconds[10:]
    p = other_k / (N - top_k)
    lim = 6 * math.sqrt((N - top_k) * p * (1 - p)) / N
    want = (top_k + other_k) / N
    print(f"GOSS path: s/iter unsampled (iterations 1-9) {unsampled} (median "
          f"{float(np.median(unsampled)):.4f}), sampled (10-13) {sampled} "
          f"(median {float(np.median(sampled)):.4f}); kept share per "
          f"iteration {shares}; expected {want:.4f} +- {lim:.4f}; sample mask "
          f"on {sorted(devices)} [{kind}, {card}]", flush=True)
    if devices != {DEV}:
        raise AssertionError(f"GOSS sample mask on {devices}, not {DEV}")
    if any(s != 1.0 for s in shares[:10]) or not all(
            abs(s - want) <= lim for s in shares[10:]):
        raise AssertionError(f"GOSS kept shares {shares}")
    if not all(b < a for a, b in zip(loss, loss[1:])):
        raise AssertionError(f"GOSS train logloss did not fall: {loss}")
    return counts


CAT_CARDINALITY = (8, 32, 100, 250)
SPARSE_BLOCK = 32


def cat_efb_data(rows: int, seed: int = 0, wide: bool = False):
    """The headline 28 columns, 4 Zipf-skewed categorical columns
    (CAT_CARDINALITY categories, p(k) ~ 1/(k+1)^1.1) and a block of
    SPARSE_BLOCK mutually exclusive count columns (each row non-zero,
    1-7, in exactly one, chosen uniformly); with ``wide`` one more
    categorical of 1,000 uniform categories.  The label depends on all
    of them.  Returns (X, y, categorical column indices)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 28))
    w = rng.normal(size=8)
    logit = X[:, :8] @ w + 0.5 * X[:, 0] * X[:, 1]
    cols, cats = [X], []
    for k in CAT_CARDINALITY:
        p = 1.0 / np.arange(1, k + 1) ** 1.1
        c = rng.choice(k, size=rows, p=p / p.sum())
        logit += rng.normal(size=k)[c] * 0.8
        cats.append(len(cats) + 28)
        cols.append(c[:, None].astype(np.float64))
    which = rng.integers(0, SPARSE_BLOCK, size=rows)
    val = rng.integers(1, 8, size=rows)
    sparse = np.zeros((rows, SPARSE_BLOCK))
    sparse[np.arange(rows), which] = val
    logit += 0.3 * (which % 3 - 1) * val / 4.0
    cols.append(sparse)
    if wide:
        c = rng.integers(0, 1000, size=rows)
        logit += rng.normal(size=1000)[c] * 0.5
        cats.append(28 + len(CAT_CARDINALITY) + SPARSE_BLOCK)
        cols.append(c[:, None].astype(np.float64))
    y = (logit + rng.logistic(size=rows) > 0).astype(np.float64)
    return np.column_stack(cols), y, cats


def cat_efb_phase(lt, hw, hc, params, kind, card):
    """Categorical features and EFB bundles at 1,000,000 rows: the
    bundled wave (K1 unfused on physical columns), categorical splits,
    the profiled iteration, and device prediction against the host walk.
    Returns the phase's counts."""
    from lightgbm_tpu_torch.core import forest
    X, y, cats = cat_efb_data(MAIN_ROWS)
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, categorical_feature=cats).construct()
    bin_s = time.perf_counter() - t0
    h = ds._handle
    print(f"categorical + EFB data ({MAIN_ROWS:,} x {X.shape[1]}): binned in "
          f"{bin_s:.2f} s; {h.num_features} features in "
          f"{h.num_phys_features} physical columns, bundles "
          f"{[g for g in h.bundle.groups if len(g) > 1]} [{card}]",
          flush=True)
    if h.bundle is None or h.num_phys_features > 28 + 4 + 4:
        raise AssertionError(f"EFB gave {h.num_phys_features} physical "
                             "columns, expected at most 36")
    bst, counts, curves, iter_ms = train_phase(
        lt, hw, hc, "categorical + EFB path", params, ds, kind, card,
        layout="k1_unfused")
    auc = curves["auc"]
    if counts["k1_fused"] or counts["k1_triple"]:
        raise AssertionError(f"bundled path launched {counts}")
    n_cat = sum(t.num_cat for t in bst._gbdt.models)
    print(f"categorical + EFB path: {n_cat} category-set nodes in "
          f"{len(bst._gbdt.models)} trees [{kind}, {card}]", flush=True)
    if n_cat == 0 or auc[-1] <= 0.7:
        raise AssertionError(f"categorical splits {n_cat}, AUC {auc[-1]}")
    profile_iteration(bst, iter_ms, kind, card)
    n = PREDICT_CHECK_ROWS
    host = bst.predict(X[:n], raw_score=True)
    host_leaf = bst.predict(X[:n], pred_leaf=True)
    before = dict(forest.calls)
    raw, raw_ms = timed(lambda: bst.predict(X, raw_score=True))
    leaf = bst.predict(X, pred_leaf=True)
    ran = {k: forest.calls[k] - before[k] for k in before}
    err = float(np.abs(raw[:n] - host).max())
    leaf_ok = np.array_equal(leaf[:n], host_leaf)
    print(f"categorical + EFB predict ({MAIN_ROWS:,} rows, "
          f"{bst._gbdt.num_trees} trees): {raw_ms:.2f} ms, device forest "
          f"calls {ran}; max |raw - host| {err:.3g} (tol 1e-4), leaves equal "
          f"{leaf_ok} [{kind}, {card}]", flush=True)
    if ran != {"predict": 1, "leaf": 1} or err > 1e-4 or not leaf_ok:
        raise AssertionError("categorical + EFB device predict disagrees "
                             "with the host walk")
    return counts


def mixed_phase(lt, hw, hc, params, kind, card):
    """The categorical + EFB data with one 1,000-category column of up to
    1,023 bins: K1's triple layout on the narrow group, the side-pass on
    the wide one; trained twice on one Dataset, equal digests.  Returns
    the first run's counts and the side-pass's per-wave times."""
    import torch
    from lightgbm_tpu_torch.core.histogram import hist_wave_side
    X, y, cats = cat_efb_data(MAIN_ROWS, seed=1, wide=True)
    mbf = [255] * X.shape[1]
    mbf[cats[-1]] = 1023
    mparams = {**params, "max_bin_by_feature": mbf}
    ds = lt.Dataset(X, label=y, categorical_feature=cats,
                    params=mparams).construct()
    runs = []
    for i in range(2):
        bst, counts, _, _ = train_phase(
            lt, hw, hc, f"mixed-width path (run {i + 1})", mparams, ds,
            kind, card, layout="k1_triple")
        runs.append((bst, counts, model_digest(bst)))
    gb = runs[0][0]._gbdt
    mixed = gb._wave_mixed
    if mixed is None or not (len(mixed.narrow_idx) and len(mixed.wide_idx)):
        raise AssertionError(f"mixed-width split {mixed}")
    counts = runs[0][1]
    if counts["k1_packed"] or counts["side_pass"] < counts["k1_triple"]:
        raise AssertionError(f"mixed path launched {counts}")
    # the side-pass at the root wave's shape and at a 42-slot wave
    wide = gb._bins_fm[1].t().contiguous()
    g = torch.randn(MAIN_ROWS, device=DEV)
    ones = torch.ones(MAIN_ROWS, device=DEV)
    slot = torch.full((128,), -1, dtype=torch.int32, device=DEV)
    slot[:3] = 0
    leaf0 = torch.zeros(MAIN_ROWS, dtype=torch.int32, device=DEV)
    root_ms = cuda_ms(lambda: hist_wave_side(wide, g, ones, ones, leaf0,
                                             slot, gb.B_phys, lanes=3),
                      reps=5)
    n42 = MAIN_ROWS // 4
    leaf = torch.randint(0, 84, (n42,), device=DEV, dtype=torch.int32)
    slot42 = torch.full((128,), -1, dtype=torch.int32, device=DEV)
    slot42[:126] = torch.arange(42, device=DEV,
                                dtype=torch.int32).repeat_interleave(3)
    ms42 = cuda_ms(lambda: hist_wave_side(wide[:n42], g[:n42], ones[:n42],
                                          ones[:n42], leaf, slot42, gb.B_phys,
                                          lanes=126), reps=5)
    print(f"mixed-width path: {len(mixed.narrow_idx)} narrow columns on K1 "
          f"(B_narrow {mixed.B_narrow}, triple), {len(mixed.wide_idx)} wide "
          f"on the side-pass (B_phys {gb.B_phys}); side-pass per wave "
          f"{root_ms:.3f} ms at the root ({MAIN_ROWS:,} rows, 1 slot), "
          f"{ms42:.3f} ms at {n42:,} rows x 42 slots; digests "
          f"{runs[0][2]} / {runs[1][2]} [{kind}, {card}]", flush=True)
    if runs[0][2] != runs[1][2]:
        raise AssertionError("the mixed-width digests differ between runs")
    return counts


def model_digest(bst) -> str:
    """First 16 hex digits of the sha256 of the model text: equal digests
    mean equal trees (two package copies on the same data compare by it)."""
    return hashlib.sha256(bst.model_to_string().encode()).hexdigest()[:16]


def legacy_parts(bst):
    """(trees text, parameter block) of ``legacy_digest``: the model text
    before its parameters, and the block written as the port wrote it
    before that block followed the JAX package's rule (the fields off
    their default only, in field order)."""
    import dataclasses
    head = bst.model_to_string().split("\nparameters:")[0]
    cfg = bst._gbdt.config
    block = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        d = (f.default if f.default is not dataclasses.MISSING
             else f.default_factory())
        if f.name != "is_parallel" and v != d:
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            block.append(f"[{f.name}: {v}]\n")
    return head, "".join(block)


def legacy_text_digest(head: str, block: str) -> str:
    text = head + "\nparameters:\n" + block + "\nend of parameters\n"
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def legacy_digest(bst) -> str:
    """``model_digest`` of the model text with the parameter block of
    ``legacy_parts``: it reproduces the digests earlier runs recorded
    (28b298b3082595ad for the main path, PERF.md), so equal values mean
    the trees did not change."""
    return legacy_text_digest(*legacy_parts(bst))


def grower_inputs(gb):
    """The next iteration's wave-grower inputs of a trained booster: bins,
    gradients and hessians at its current score, bag mask, feature mask."""
    g, h = gb.objective.get_gradients(gb._train_score)
    return gb._bins_fm, g, h, gb._bag_mask, gb._feature_mask()


def triple_path(hw, hc, gb, kind, card):
    """The wave grower in the triple layout (42 leaves a wave; the JAX
    package's layout for mixed-width data) against the packed one at the
    same capacity, one int16 tree each at the main path's width on the
    same inputs.  Integer sums are exact in both layouts, so the trees and
    row partitions must be identical.  The counts are set to 0 just before
    each tree and read just after.  Returns the triple tree's counts."""
    import torch
    from lightgbm_tpu_torch.core.wave_grower import build_wave_grow_fn
    cfg = gb.config
    args = grower_inputs(gb)
    res = {}
    for packed in (True, False):
        grow = build_wave_grow_fn(
            gb.meta, gb.split_cfg, gb.B,
            wave_capacity=hw.wave_capacity_max(False), highest="int16",
            gain_gate=float(cfg.tpu_wave_gain_gate),
            fused_sibling=bool(cfg.tpu_fused_sibling), packed=packed,
            quant_seed=int(cfg.seed))
        torch.cuda.synchronize()
        reset_counts(hw, hc)
        t0 = time.perf_counter()
        arrs, leaf_id, (waves, _) = grow(*args)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        res[packed] = (arrs, leaf_id, waves, read_counts(hw, hc), sec)
    (pa, pl, pw, pc, ps), (ta, tl, tw, tc, ts) = res[True], res[False]
    print(f"triple grower path: {int(ta.num_leaves)} leaves in {tw} waves, "
          f"{ts:.4f} s; packed twin {int(pa.num_leaves)} leaves in {pw} "
          f"waves, {ps:.4f} s; launches triple {tc}, packed {pc} [{kind}, "
          f"{card}]", flush=True)
    if tc["k1_triple"] < tw or tc["k1_triple"] == 0 or tc["k1_packed"]:
        raise AssertionError(f"triple grower: K1 launches {tc} for {tw} "
                             "waves")
    for k in pa._fields:
        a, b = getattr(pa, k), getattr(ta, k)
        if not (torch.equal(a, b) or (a.is_floating_point() and torch.allclose(
                a, b, rtol=0, atol=0, equal_nan=True))):
            raise AssertionError(f"triple and packed int16 trees differ in "
                                 f"{k}")
    if not torch.equal(pl, tl):
        raise AssertionError("triple and packed row partitions differ")
    return tc


def channels_path(hw, hc, gb, kind, card):
    """K2 through its single-leaf form ``hist_channels_fm`` (the JAX
    package's ``hist_pallas_fm``) on the main path's bins and gradients:
    the root histogram, whose per-feature sums are the whole-data totals.
    The counts are set to 0 just before and read just after."""
    import torch
    bins_fm, g, h, mask, _ = grower_inputs(gb)
    torch.cuda.synchronize()
    reset_counts(hw, hc)
    hist = hc.hist_channels_fm(bins_fm, g, h, mask, gb.B)
    torch.cuda.synchronize()
    counts = read_counts(hw, hc)
    if counts["k2"] != 1 or counts["k1"]:
        raise AssertionError(f"K2 path: launches {counts}")
    per_f = hist.double().sum(1)                            # [F, 3]
    gm, hm = (g * mask).double(), (h * mask).double()
    total = torch.stack([gm.sum(), hm.sum(), mask.double().sum()])
    lim = REL_TOL * torch.stack([gm.abs().sum(), hm.abs().sum(),
                                 torch.zeros((), device=DEV,
                                             dtype=torch.float64)]) + 1e-6
    err = (per_f - total).abs()
    print(f"K2 path (root histogram {tuple(hist.shape)}): max |per-feature "
          f"sum - total| {err.max(0).values.tolist()}, launches {counts} "
          f"[{kind}, {card}]", flush=True)
    if not bool((err <= lim).all()):
        raise AssertionError("K2 root histogram does not sum to the totals")
    return counts


def native_binning(lt, X, y, card):
    """Bin the main path's matrix through the native library (which must
    have loaded) and through the numpy path; equal bytes.  Returns the
    native Dataset."""
    from lightgbm_tpu_torch import native
    if native.lib() is None:
        raise AssertionError("the native binning library did not load "
                             "(g++ -O3 -fopenmp)")
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y).construct()
    native_s = time.perf_counter() - t0
    lib = native.lib
    native.lib = lambda: None           # the numpy fallback, same matrix
    try:
        t0 = time.perf_counter()
        plain = lt.Dataset(X, label=y).construct()
        numpy_s = time.perf_counter() - t0
    finally:
        native.lib = lib
    if plain._handle.X_bin.tobytes() != ds._handle.X_bin.tobytes():
        raise AssertionError("native and numpy binning disagree")
    print(f"binning {MAIN_ROWS:,} x 28 (host): native path {native_s:.2f} s, "
          f"numpy path {numpy_s:.2f} s, X_bin equal; the main path uses the "
          f"native path ({native.lib()._name}) [{card}]", flush=True)
    return ds


def timed(fn):
    """(result, ms) of one call, by CUDA events."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def device_ops(fn) -> dict:
    """Kernel launches and copies on the card in one call of ``fn``
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {"kernels": 0, "copies": 0}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if dev_us > 0 and ev.key and not ev.key.startswith(
                ("aten::", "ProfilerStep", "cudaDeviceSynchronize")):
            ops["copies" if ev.key.startswith("Memcpy") else "kernels"] += \
                ev.count
    return ops


PREDICT_CHECK_ROWS = 20_000
EARLY_STOP = {"pred_early_stop": True, "pred_early_stop_freq": 1,
              "pred_early_stop_margin": 1.5}


def predict_phase(lt, bst, X, kind, card):
    """Phase 4's booster, then a booster loaded from its model text, predict
    every row on the card through the stacked forest; held against the host
    walk on the first rows."""
    from lightgbm_tpu_torch.core import forest
    n = PREDICT_CHECK_ROWS
    host = {"raw": bst.predict(X[:n], raw_score=True),
            "leaf": bst.predict(X[:n], pred_leaf=True),
            "es": bst.predict(X[:n], raw_score=True, **EARLY_STOP)}
    loaded = lt.Booster(model_str=bst.model_to_string())
    for name, b, tol in (("trained", bst, 1e-4), ("loaded", loaded, 1e-6)):
        before = dict(forest.calls)
        raw, raw_ms = timed(lambda: b.predict(X, raw_score=True))
        leaf, leaf_ms = timed(lambda: b.predict(X, pred_leaf=True))
        es, es_ms = timed(lambda: b.predict(X, raw_score=True, **EARLY_STOP))
        ran = {k: forest.calls[k] - before[k] for k in before}
        if ran != {"predict": 2, "leaf": 1}:
            raise AssertionError(f"{name}: device forest calls {ran}, "
                                 "expected 2 predict and 1 leaf")
        err = float(np.abs(raw[:n] - host["raw"]).max())
        es_err = float(np.abs(es[:n] - host["es"]).max())
        leaf_ok = np.array_equal(leaf[:n], host["leaf"])
        g = b._gbdt
        space, meta, walk = g._forest_device(0, g.current_iteration())
        bins = g._device_bins(X, space)
        scan = forest.forest_predict_fn(meta, 1)
        scan_ms = cuda_ms(lambda: scan(walk, bins), reps=5)
        ops = device_ops(lambda: b.predict(X, raw_score=True))
        scan_ops = device_ops(lambda: scan(walk, bins))
        rows = X.shape[0]
        print(f"predict ({name}, {rows:,} rows x {g.num_trees} trees of "
              f"depth {walk.depth.tolist()}): raw {raw_ms:.2f} ms "
              f"({rows / raw_ms * 1e3:,.0f} rows/s), leaf {leaf_ms:.2f} ms, "
              f"early stop {es_ms:.2f} ms; forest walk alone {scan_ms:.3f} ms "
              f"({rows / scan_ms * 1e3:,.0f} rows/s); card ops per predict "
              f"call {ops}, per walk {scan_ops}; max |raw - host| {err:.3g} "
              f"(tol {tol:g}), early stop {es_err:.3g} (tol 1e-6), leaves "
              f"equal {leaf_ok} [{kind}, {card}]", flush=True)
        if not (err <= tol and es_err <= 1e-6 and leaf_ok
                and np.all(np.isfinite(raw))):
            raise AssertionError(f"{name}: device predict disagrees with "
                                 "the host walk")


def cli_phase(lt, kind, card, rows=200_000):
    """``python -m lightgbm_tpu_torch`` task=train then task=predict on a
    TSV, each a subprocess on the card; task=predict goes through a
    ``PredictorSession`` (``LGBM_TPU_PREDICT_MIN_WORK=0``: the JAX
    package's route for heavy work) and its output equals
    ``Booster(model_file=...).predict`` on the file's rows, taken through
    the Booster's stacked-forest walk (the session's arithmetic).  Returns
    the model file, kept under ``SCRATCH`` for phase 29's ``task=refit``."""
    import tempfile
    from lightgbm_tpu_torch.boosting.gbdt import PredictorBase
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.text_loader import load_text
    X, y = higgs_like(rows, seed=2)
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "higgs.tsv")
        model = os.path.join(d, "model.txt")
        out = os.path.join(d, "pred.txt")
        np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
        walls = {}
        for task, args in (
                ("train", ["verbosity=-1", f"data={data}", "objective=binary",
                           "num_trees=5", "num_leaves=255", "max_bin=255",
                           "min_data_in_leaf=100", f"output_model={model}"]),
                ("predict", [f"data={data}", f"input_model={model}",
                             f"output_result={out}"])):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "lightgbm_tpu_torch", f"task={task}",
                 *args], cwd=d, capture_output=True, text=True, timeout=600,
                env=dict(env, LGBM_TPU_PREDICT_MIN_WORK="0"))
            walls[task] = time.perf_counter() - t0
            if r.returncode != 0:
                raise AssertionError(f"CLI task={task} exited "
                                     f"{r.returncode}: {r.stderr[-2000:]}")
        via_session = "through a PredictorSession" in r.stderr
        Xf = load_text(data, Config())[0]
        saved = PredictorBase._DEVICE_PREDICT_MIN_WORK
        PredictorBase._DEVICE_PREDICT_MIN_WORK = 0
        try:
            want = lt.Booster(model_file=model).predict(Xf)
        finally:
            PredictorBase._DEVICE_PREDICT_MIN_WORK = saved
        got = np.loadtxt(out)
        err = float(np.abs(got - want).max())
        with open(model) as fh:
            trees = fh.read().count("\nTree=")
        # phase 29 refits this model through task=refit
        os.makedirs(SCRATCH, exist_ok=True)
        kept = os.path.join(SCRATCH, "cli_model.txt")
        with open(model) as src, open(kept, "w") as dst:
            dst.write(src.read())
    print(f"CLI ({rows:,} x 28 TSV): task=train {walls['train']:.1f} s wall "
          f"({trees} trees), task=predict {walls['predict']:.1f} s wall "
          f"(through a PredictorSession: {via_session}); max |output - "
          f"Booster(model_file).predict| {err:.3g} (tol 1e-10) "
          f"[{kind}, {card}]", flush=True)
    if trees != 5 or err > 1e-10 or not via_session:
        raise AssertionError("CLI output disagrees with Booster.predict")
    return kept


COVTYPE_ROWS = 581_012
# Covertype's class shares (cover types 1-7 of its 581,012 rows)
COVTYPE_SHARES = (0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035)


def covertype_like(rows: int = COVTYPE_ROWS, seed: int = 3):
    """Covertype-shaped multiclass data: 10 integer-valued continuous
    columns at Covertype's means and spreads, a 4-column wilderness
    one-hot and a 40-column soil one-hot (Zipf-skewed), and 7 classes drawn
    from a seeded softmax of a blend of them whose biases are fitted so
    the expected class shares are Covertype's."""
    rng = np.random.default_rng(seed)
    mean = np.array([2959, 156, 14, 269, 46, 2350, 212, 223, 142, 1980.])
    std = np.array([280, 112, 7.5, 212, 58, 1559, 27, 20, 38, 1324.])
    z = rng.normal(size=(rows, 10))
    wild = rng.choice(4, size=rows, p=[0.45, 0.05, 0.44, 0.06])
    p = 1.0 / np.arange(1, 41) ** 1.2
    soil = rng.choice(40, size=rows, p=p / p.sum())
    K = len(COVTYPE_SHARES)
    shares = np.asarray(COVTYPE_SHARES)
    blend = (z @ rng.normal(size=(10, K)) + rng.normal(size=(4, K))[wild]
             + rng.normal(size=(40, K))[soil]
             + 0.5 * z[:, :1] * z[:, 1:2] * rng.normal(size=K))
    bias = np.log(shares)
    for _ in range(20):
        lg = blend + bias
        e = np.exp(lg - lg.max(1, keepdims=True))
        prob = e / e.sum(1, keepdims=True)
        bias += np.log(shares / prob.mean(0))
    y = (rng.random(rows)[:, None] > np.cumsum(prob, axis=1)).sum(1)
    X = np.zeros((rows, 54))
    X[:, :10] = np.round(mean + std * z)
    X[np.arange(rows), 10 + wild] = 1.0
    X[np.arange(rows), 14 + soil] = 1.0
    return X, np.minimum(y, K - 1).astype(np.float64)


def multiclass_phase(lt, hw, hc, res, kind, card):
    """Covertype-shaped multiclass at 581,012 x 54 (EFB bundles the one-hot
    blocks): K1 at the bundled column count against its plain version;
    ``objective=multiclass, num_class=7``, 255 leaves, 5 rounds (35 trees),
    trained twice on one Dataset, one digest, multi_logloss falling every
    round; one profiled iteration; device prediction of every row against
    the host walk on the first rows (probabilities, 1e-6); then 2 rounds
    of multiclassova.
    Returns the first run's counts, the TreeSHAP line, and the model file
    with 2,000 of its rows (the arena's tenant)."""
    from lightgbm_tpu_torch.core import forest
    t0 = time.perf_counter()
    X, y = covertype_like()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y).construct()
    bin_s = time.perf_counter() - t0
    h = ds._handle
    F_phys = h.num_phys_features
    shares = np.bincount(y.astype(np.int64), minlength=7) / len(y)
    print(f"multiclass data ({COVTYPE_ROWS:,} x 54, Covertype-shaped, seed 3):"
          f" generated in {gen_s:.2f} s, binned in {bin_s:.2f} s; class "
          f"shares {np.round(shares, 4).tolist()}; {h.num_features} features "
          f"in {F_phys} physical columns [{card}]", flush=True)
    if h.bundle is None or F_phys > 16:
        raise AssertionError(f"EFB gave {F_phys} physical columns for the "
                             "one-hot blocks, expected at most 16")
    phase_check(hw, res, "k1_multiclass", COVTYPE_ROWS, F_phys, 63, False,
                301, kind, card)
    params = {"objective": "multiclass", "num_class": 7,
              "metric": ["multi_logloss", "multi_error"], "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255, "min_data_in_leaf": 100,
              "verbose": -1}
    runs = []
    for i in range(2):
        bst, counts, curves, iter_ms = train_phase(
            lt, hw, hc, f"multiclass path (run {i + 1})", params, ds, kind,
            card, layout="k1_unfused")
        runs.append((bst, counts, model_digest(bst)))
        loss = curves["multi_logloss"]
        if not all(b < a for a, b in zip(loss, loss[1:])):
            raise AssertionError(f"multi_logloss did not fall: {loss}")
    print(f"multiclass path: {iter_ms / 1e3:.4f} s/iter (7 trees an "
          f"iteration), K1 launches {runs[0][1]['k1']} in 35 trees; digests "
          f"{runs[0][2]} / {runs[1][2]} [{kind}, {card}]", flush=True)
    if runs[0][2] != runs[1][2]:
        raise AssertionError("two multiclass trainings on one Dataset differ")
    bst = runs[0][0]
    profile_iteration(bst, iter_ms, kind, card)
    n = PREDICT_CHECK_ROWS
    host = bst.predict(X[:n])
    before = dict(forest.calls)
    prob, ms = timed(lambda: bst.predict(X))
    ran = {k: forest.calls[k] - before[k] for k in before}
    err = float(np.abs(prob[:n] - host).max())
    print(f"multiclass predict ({COVTYPE_ROWS:,} rows x "
          f"{bst._gbdt.num_trees} trees): {ms:.2f} "
          f"ms, device forest calls {ran}; max |probability - host walk| "
          f"{err:.3g} (tol 1e-6), rows sum to 1 within "
          f"{float(np.abs(prob.sum(1) - 1).max()):.3g} [{kind}, {card}]",
          flush=True)
    if ran["predict"] != 1 or err > 1e-6 or prob.shape != (COVTYPE_ROWS, 7):
        raise AssertionError("multiclass device predict disagrees with the "
                             "host walk")
    # the first iteration's trees on 100 rows, the last's (the deepest
    # paths) on 50
    last = bst._gbdt.current_iteration()
    shap = treeshap_phase(bst, X, "multiclass", SHAP_MULTICLASS_ROWS,
                          [(SHAP_ORACLE_ROWS, (0, 1)), (50, (last - 1, last))],
                          kind, card)
    _, ova_counts, ova, _ = train_phase(
        lt, hw, hc, "multiclassova path",
        {**params, "objective": "multiclassova"}, ds, kind, card, rounds=2,
        layout="k1_unfused")
    if not all(math.isfinite(v) for v in ova["multi_error"]):
        raise AssertionError(f"multiclassova multi_error {ova}")
    # the arena's multiclass tenant (phase 24): the model file and rows
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "multiclass_model.txt")
    bst.save_model(path)
    return runs[0][1], shap, (path, X[:2000].copy())


RANK_ROWS = 2_270_296            # MSLR-WEB30K fold 1's training rows


def mslr_like(rows: int = RANK_ROWS):
    """bench.py's ``_rank_data``: MSLR-WEB30K-shaped ragged queries from
    the port's ``ops/rank.py mslr_like_sizes`` (seed 0), 136 features, and
    grades 0-4 by within-query quantiles of a noisy feature blend."""
    from lightgbm_tpu_torch.ops.rank import mslr_like_sizes
    rng = np.random.default_rng(0)
    sizes = mslr_like_sizes(rows, rng=rng)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 136))
    score = X[:, :12] @ rng.normal(size=12) + rng.logistic(size=n) * 2.0
    y = np.zeros(n)
    lo = 0
    for s in sizes:
        q = score[lo:lo + s]
        y[lo:lo + s] = np.searchsorted(
            np.quantile(q, [0.5, 0.75, 0.9, 0.97]), q)
        lo += s
    return X, y, sizes


def rank_phase(lt, hw, hc, res, kind, card):
    """Lambdarank at MSLR-WEB30K's shape (2,270,296 x 136): K1 packed fused
    at F = 136 against its plain version; bench.py ``_run_rank``'s
    parameters, 5 rounds, trained twice on one Dataset, one digest; one
    profiled iteration; the pair pass's ms per iteration by CUDA events
    against its bound; the device NDCG@10 against the host loop (1e-6).
    Returns the first run's counts and the pair pass's numbers."""
    import torch
    from lightgbm_tpu_torch.ops.rank import rank_pair_cost
    t0 = time.perf_counter()
    X, y, sizes = mslr_like()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, group=sizes).construct()
    bin_s = time.perf_counter() - t0
    del X
    print(f"lambdarank data ({RANK_ROWS:,} x 136 in {len(sizes):,} queries "
          f"of 1-{int(sizes.max())} documents, MSLR-WEB30K-shaped): generated "
          f"in {gen_s:.2f} s, binned in {bin_s:.2f} s [{card}]", flush=True)
    phase_check(hw, res, "k1_rank", RANK_ROWS, 136, 63, True, 302, kind,
                card)
    torch.cuda.empty_cache()
    params = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [10],
              "num_leaves": 255, "learning_rate": 0.1, "max_bin": 255,
              "min_data_in_leaf": 50, "min_sum_hessian_in_leaf": 5.0,
              "verbose": -1}
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        bst, counts, curves, iter_ms = train_phase(
            lt, hw, hc, f"lambdarank path (run {i + 1})", params, ds, kind,
            card)
        runs.append((bst, counts, model_digest(bst),
                     time.perf_counter() - t0))
    print(f"lambdarank path: {iter_ms / 1e3:.4f} s/iter; wall per run "
          f"(Booster init with the query blocks, 5 rounds, NDCG every round) "
          f"{runs[0][3]:.1f} / {runs[1][3]:.1f} s; digests {runs[0][2]} / "
          f"{runs[1][2]} [{kind}, {card}]", flush=True)
    if runs[0][2] != runs[1][2]:
        raise AssertionError("two lambdarank trainings on one Dataset differ")
    profile_iteration(runs[0][0], iter_ms, kind, card)
    gb = runs[0][0]._gbdt
    del runs
    obj, score = gb.objective, gb._train_score
    pair_ms = cuda_ms(lambda: obj.get_gradients(score), reps=5)
    from lightgbm_tpu_torch.core.query import pair_chunk_elems
    ops, n_bytes = rank_pair_cost(sizes, chunk_elems=1)
    pb = bound(n_bytes, ops)
    n_chunks = sum(-(-b.idx.shape[0] // max(1, pair_chunk_elems(DEV)
                                            // (b.P * b.P)))
                   for b in obj.qblocks.buckets)
    m = gb.metrics[0]
    dev = m.eval(score, obj)[0][1]
    host = m.eval_host(score.double().cpu().numpy())[0][1]
    print(f"lambdarank pair pass: {pair_ms:.3f} ms per iteration (CUDA "
          f"events, median of 5, {n_chunks} chunks of up to "
          f"{pair_chunk_elems(DEV):,} pair elements); bound {pb['bound_ms']:.4f}"
          f" ms by {pb['bound_by']} ({ops:.4g} operations, {n_bytes:.4g} "
          f"bytes: {n_bytes / peaks()[0] * 1e3:.4f} ms at 3.35 TB/s); "
          f"train NDCG@10 device {dev!r}, host loop {host!r}, |diff| "
          f"{abs(dev - host):.3g} (tol 1e-6) [{kind}, {card}]", flush=True)
    if abs(dev - host) > 1e-6 or not 0.0 < dev <= 1.0:
        raise AssertionError("device NDCG@10 disagrees with the host loop")
    pair = {"name": "pair_lambdas (lambdarank pair pass, torch)",
            "route": "torch", "source": "lightgbm_tpu_torch/objective/rank.py",
            "replaces": "lightgbm_tpu/objective/rank.py:50 (XLA)",
            "ms": pair_ms, "bound_ms": pb["bound_ms"],
            "bound_by": pb["bound_by"], "bytes_ms": n_bytes / peaks()[0]
            * 1e3, "library_ms": None, "calls_per_iteration": 1}
    return counts, pair


def regression_phase(lt, hw, hc, kind, card):
    """Regression on the headline HIGGS-shaped rows (the label a seeded
    noisy blend of them) with seeded positive sample weights: ``regression``
    and ``quantile`` (alpha 0.9, the host leaf refit), 5 rounds each,
    trained twice, one digest each; the metric falls every round.  Returns
    the first regression run's counts and its model file (the arena's
    tenant)."""
    X, _ = higgs_like(MAIN_ROWS)
    rng = np.random.default_rng(5)
    y = (X[:, :8] @ rng.normal(size=8) + 0.5 * X[:, 0] * X[:, 1]
         + rng.normal(size=MAIN_ROWS) * 0.5)
    w = rng.uniform(0.5, 2.0, size=MAIN_ROWS)
    ds = lt.Dataset(X, label=y, weight=w).construct()
    del X
    base = {"num_leaves": 255, "learning_rate": 0.1, "max_bin": 255,
            "min_data_in_leaf": 100, "verbose": -1}
    first = path = None
    for obj, metric, extra in (("regression", "l2", {}),
                               ("quantile", "quantile", {"alpha": 0.9})):
        digests = []
        for i in range(2):
            bst, counts, curves, iter_ms = train_phase(
                lt, hw, hc, f"{obj} path (run {i + 1})",
                {**base, "objective": obj, "metric": [metric], **extra}, ds,
                kind, card)
            digests.append(model_digest(bst))
            if first is None:
                # the arena's weighted-regression tenant (phase 24)
                first = counts
                os.makedirs(SCRATCH, exist_ok=True)
                path = os.path.join(SCRATCH, "regression_model.txt")
                bst.save_model(path)
            loss = curves[metric]
            if not all(b < a for a, b in zip(loss, loss[1:])):
                raise AssertionError(f"{obj}: {metric} did not fall: {loss}")
        renew = bst._gbdt.renew_seconds
        print(f"{obj} path (weighted): {iter_ms / 1e3:.4f} s/iter, of which "
              f"the host leaf refit {float(np.median(renew)) if renew else 0.0:.4f}"
              f" s (median per tree, {len(renew)} refits); digests "
              f"{digests[0]} / {digests[1]} [{kind}, {card}]", flush=True)
        if digests[0] != digests[1]:
            raise AssertionError(f"two {obj} trainings on one Dataset differ")
    return first, path


FORCED_SPLITS = os.path.join(HERE, "tests", "fixtures", "forced_splits.json")
FORCED_PREFIX = (25, 10, 4)      # the fixture's BFS features


def serial_phase(lt, hw, hc, params, ds, X, y, kind, card):
    """(a) The serial grower at the headline width: forced splits
    (``tests/fixtures/forced_splits.json``), CEGB (split penalty 0.02, a
    coupled penalty on every column, a lazy one on a few) and by-node
    sampling (0.5), 3 rounds, trained twice with one digest; the forced
    BFS prefix stands in every tree; K2 (C = 32) takes every leaf
    histogram.  (b) The same rows at ``max_bin=1023``: every column has
    more than 256 bins, the serial grower's fixed-point wide histogram
    takes every leaf, 3 rounds twice with one digest; its ms per leaf at
    the root by CUDA events, beside the mixed-width side-pass
    (``hist_wave_side``) with one slot at the same shape.  Returns (narrow
    counts, wide counts, wide ms, side-pass ms)."""
    import torch
    from lightgbm_tpu_torch.core.histogram import (hist_fixed_point,
                                                   hist_wave_side)
    F = X.shape[1]
    # relative to the working directory (the repository's root, where the
    # script runs): the path lands in the model text, so the digest of an
    # unchanged tree must not depend on where the checkout is
    narrow = {**params, "forcedsplits_filename": os.path.relpath(
        FORCED_SPLITS),
              "cegb_penalty_split": 0.02,
              "cegb_penalty_feature_coupled": [0.5] * F,
              "cegb_penalty_feature_lazy": [1e-5] * 4 + [0.0] * (F - 4),
              "feature_fraction_bynode": 0.5}
    out = []
    for name, p, d, layout in (
            ("serial grower (forced, CEGB, by-node)", narrow, ds, "k2"),
            ("serial grower (all-wide, max_bin 1023)",
             {**params, "max_bin": 1023}, None, "wide_hist")):
        if d is None:
            t0 = time.perf_counter()
            d = lt.Dataset(X, label=y, params={"max_bin": 1023}).construct()
            phys = d._handle.phys_max_bins()
            print(f"{name}: binned in {time.perf_counter() - t0:.2f} s, "
                  f"{len(phys)} columns of {int(phys.min())}-"
                  f"{int(phys.max())} bins, X_bin {d._handle.X_bin.dtype} "
                  f"[{card}]", flush=True)
        runs = []
        for i in range(2):
            bst, counts, curves, iter_ms = train_phase(
                lt, hw, hc, f"{name} (run {i + 1})", p, d, kind, card,
                rounds=3, layout=layout)
            runs.append((bst, counts, model_digest(bst), iter_ms))
        gb = runs[0][0]._gbdt
        if gb.uses_wave:
            raise AssertionError(f"{name}: the wave grower took the data")
        passes = sum(w for w, _ in gb.wave_stats)
        print(f"{name}: {layout} launches {runs[0][1][layout]} for "
              f"{passes} leaf histograms in 3 trees of "
              f"{[t.num_leaves for t in gb.models]} leaves; K1 launches "
              f"{runs[0][1]['k1']}; {runs[0][3] / 1e3:.4f} / "
              f"{runs[1][3] / 1e3:.4f} s/iter; digests {runs[0][2]} / "
              f"{runs[1][2]} [{kind}, {card}]", flush=True)
        if runs[0][2] != runs[1][2]:
            raise AssertionError(f"{name}: two trainings differ")
        if runs[0][1]["k1"] or runs[0][1][layout] != passes:
            raise AssertionError(f"{name}: launches {runs[0][1]} for "
                                 f"{passes} leaf histograms")
        if layout == "k2":
            for t in gb.models:
                if (tuple(t.split_feature[:3]) != FORCED_PREFIX
                        or t.left_child[0] != 1 or t.right_child[0] != 2):
                    raise AssertionError(
                        f"{name}: forced prefix missing: features "
                        f"{t.split_feature[:3]}, children "
                        f"{t.left_child[0]}, {t.right_child[0]}")
            print(f"{name}: forced BFS prefix {FORCED_PREFIX} in all "
                  f"{len(gb.models)} trees [{kind}, {card}]", flush=True)
        else:
            g, h = gb.objective.get_gradients(gb._train_score)
            wide = gb._bins_fm[1]
            mask = gb._bag_mask
            calls = hist_fixed_point.calls, hist_wave_side.calls
            wide_ms = cuda_ms(lambda: hist_fixed_point(
                wide, g, h, mask, gb.B_phys), reps=5)
            # the mixed-width wave's side-pass in the same role: one slot
            # (leaf 0, lanes g, h, count) over the row-major bins
            wide_rm = wide.t().contiguous()
            slot = torch.full((128,), -1, dtype=torch.int32, device=DEV)
            slot[:3] = 0
            leaf0 = torch.zeros(wide.shape[1], dtype=torch.int32, device=DEV)

            def side():
                return hist_wave_side(wide_rm, g * mask, h * mask, mask,
                                      leaf0, slot, gb.B_phys, lanes=3)
            side_ms = cuda_ms(side, reps=3)
            fixed = hist_fixed_point(wide, g, h, mask, gb.B_phys)
            side_err = float((side()[..., :3] - fixed).abs().max())
            hist_fixed_point.calls, hist_wave_side.calls = calls
            del wide_rm, leaf0
            # its bound: the bins as uint16 (the dataset's X_bin) and the
            # int64 fixed-point g and h read once, the f32 histogram
            # written once
            Fw, n = wide.shape
            wide_bound = bound(n * Fw * 2 + n * 16 + Fw * gb.B_phys * 3 * 4,
                               0)["bound_ms"]
            print(f"{name}: wide histogram of the root leaf ({wide.shape[1]:,}"
                  f" rows x {wide.shape[0]} columns x {gb.B_phys} bins) "
                  f"{wide_ms:.3f} ms (CUDA events, median of 5), bound "
                  f"{wide_bound:.4f} ms (bytes); the "
                  f"side-pass hist_wave_side in its place {side_ms:.3f} ms "
                  f"(median of 3), max |side-pass - fixed point| "
                  f"{side_err:.3g}; "
                  f"{sum(r for _, r in gb.wave_stats) / max(passes, 1):,.0f}"
                  f" rows a leaf histogram on average [{kind}, {card}]",
                  flush=True)
        profile_iteration(runs[0][0], runs[0][3], kind, card)
        out.append(runs[0][1])
        del runs
    return out[0], out[1], wide_ms, side_ms, wide_bound


def cegb_wave_phase(lt, hw, hc, params, ds, kind, card):
    """CEGB without lazy penalties on the wave grower, as the JAX package
    grows it: split penalty 0.02 and a coupled one of 0.5 on every column,
    3 rounds trained twice with one digest, K1 packed on every wave.
    Returns the first run's counts."""
    p = {**params, "cegb_penalty_split": 0.02,
         "cegb_penalty_feature_coupled": [0.5] * 28}
    runs = []
    for i in range(2):
        bst, counts, _, iter_ms = train_phase(
            lt, hw, hc, f"wave grower with CEGB (run {i + 1})", p, ds, kind,
            card, rounds=3)
        runs.append((bst._gbdt.uses_wave, counts, model_digest(bst),
                     iter_ms))
        del bst
    print(f"wave grower with CEGB: {runs[0][3] / 1e3:.4f} / "
          f"{runs[1][3] / 1e3:.4f} s/iter; digests {runs[0][2]} / "
          f"{runs[1][2]} [{kind}, {card}]", flush=True)
    if not (runs[0][0] and runs[1][0]):
        raise AssertionError("CEGB without lazy penalties left the wave")
    if runs[0][2] != runs[1][2]:
        raise AssertionError("wave grower with CEGB: two trainings differ")
    return runs[0][1]


def api_phase(lt, params, ds, X, y, kind, card):
    """(d) Continued training and the rest of the training API on the
    headline rows, at 31 leaves (depth cut: fewer near-tied splits between
    a continued and an uninterrupted run): 5 rounds saved, 5 more from the
    file through ``init_model``, probabilities within 1e-4 of 10
    uninterrupted rounds (the JAX package's tolerance); init scores from
    the 5-round model's raw scores, plus 5 rounds, within 1e-4 in raw score
of the continued model; a numpy binary-logloss ``fobj`` with an
    AUC ``feval``; ``learning_rates`` as a decaying list; ``cv`` with 3
    folds and 5 rounds.  Each run is trained twice with one digest (``cv``:
    equal results); wall seconds of each."""
    import tempfile
    p = {**params, "num_leaves": 31}
    n = PREDICT_CHECK_ROWS

    def auc(pred, label):
        order = np.argsort(pred, kind="stable")
        ranks = np.empty(len(pred))
        ranks[order] = np.arange(1, len(pred) + 1)
        pos = label == 1
        return float((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
                     / (pos.sum() * (~pos).sum()))

    def fobj(preds, data):
        lab = data.get_label()
        prob = 1.0 / (1.0 + np.exp(-preds))
        return prob - lab, prob * (1.0 - prob)

    def feval(preds, data):
        return "auc_custom", auc(preds, data.get_label()), True

    def twice(name, fn, digest=model_digest):
        walls, outs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(fn())
            walls.append(time.perf_counter() - t0)
        d = [digest(o) for o in outs]
        print(f"API {name}: wall {walls[0]:.2f} / {walls[1]:.2f} s; digests "
              f"{d[0]} / {d[1]} [{kind}, {card}]", flush=True)
        if d[0] != d[1]:
            raise AssertionError(f"API {name}: two runs differ")
        return outs[0]

    full = twice("10 rounds uninterrupted",
                 lambda: lt.train(p, ds, 10, device=DEV))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "five.txt")
        first = lt.train(p, ds, 5, device=DEV)
        first.save_model(path)
        cont = twice("5 rounds + 5 from the file (init_model)",
                     lambda: lt.train(p, ds, 5, init_model=path, device=DEV))
    err = float(np.abs(cont.predict(X[:n]) - full.predict(X[:n])).max())
    print(f"API continued vs uninterrupted: {cont.num_trees()} trees, max "
          f"|probability difference| {err:.3g} on {n:,} rows (tol 1e-4) "
          f"[{kind}, {card}]", flush=True)
    if cont.num_trees() != 10 or err > 1e-4:
        raise AssertionError("continued training differs from 10 rounds")
    init = first.predict(X, raw_score=True)
    ds_init = lt.Dataset(X, label=y, init_score=init, reference=ds)
    with_init = twice("init scores from the 5-round model",
                      lambda: lt.train(p, ds_init, 5, device=DEV))
    gap = float(np.abs(init[:n] + with_init.predict(X[:n], raw_score=True)
                       - cont.predict(X[:n], raw_score=True)).max())
    print(f"API init scores: max |init + 5 rounds - continued| raw {gap:.3g}"
          f" on {n:,} rows (tol 1e-4) [{kind}, {card}]", flush=True)
    if not gap <= 1e-4:
        raise AssertionError("init scores + 5 rounds differ from the "
                             "continued model")
    ev = {}
    custom = twice("fobj (numpy logloss) + feval (AUC)",
                   lambda: lt.train(p, ds, 5, fobj=fobj, feval=feval,
                                    valid_sets=[ds], valid_names=["train"],
                                    evals_result=ev, device=DEV))
    cauc = ev["train"]["auc_custom"]
    print(f"API fobj/feval: train AUC by feval {cauc} [{kind}, {card}]",
          flush=True)
    if not (cauc[-1] > 0.7 and all(b >= a for a, b in zip(cauc, cauc[1:]))):
        raise AssertionError(f"custom objective AUC {cauc}")
    del custom
    twice("learning_rates [0.2, 0.15, 0.1, 0.07, 0.05]",
          lambda: lt.train(p, ds, 5, learning_rates=[0.2, 0.15, 0.1, 0.07,
                                                     0.05], device=DEV))
    full_ds = lt.Dataset(X, label=y, free_raw_data=False)
    res = twice("cv (3 folds, 5 rounds)",
                lambda: lt.cv({**p, "metric": "binary_logloss"}, full_ds, 5,
                              nfold=3, device=DEV),
                digest=lambda r: hashlib.sha256(json.dumps(
                    r, sort_keys=True).encode()).hexdigest()[:16])
    curve = res["valid binary_logloss-mean"]
    print(f"API cv: valid binary_logloss mean {curve}, stdv "
          f"{res['valid binary_logloss-stdv']} [{kind}, {card}]", flush=True)
    if not all(b < a for a, b in zip(curve, curve[1:])):
        raise AssertionError(f"cv logloss did not fall: {curve}")


SPARSE_ROWS, SPARSE_COLS, SPARSE_PER_ROW = 1_000_000, 5_000, 8
SPARSE_PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 15,
                 "min_data_in_leaf": 20, "max_conflict_rate": 0.1,
                 "verbose": -1}


def sparse_data():
    """(CSR, label) of phase (e), from seed 0: ``tests/test_sparse.py``'s
    generator at ``SPARSE_ROWS`` rows."""
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    n, f, k = SPARSE_ROWS, SPARSE_COLS, SPARSE_PER_ROW
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, f, size=n * k)
    informative = cols < 50
    vals = np.where(informative, 1.0 + rng.random(n * k),
                    rng.normal(size=n * k))
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, f))
    signal = np.zeros(n)
    np.add.at(signal, rows[informative], vals[informative])
    y = (signal + 0.5 * rng.normal(size=n) > 1.0).astype(np.float64)
    return X, y


def proc_status(key: str) -> int:
    """A byte count of /proc/self/status (VmRSS, VmHWM)."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise AssertionError(f"/proc/self/status has no {key}")


def sparse_build_child():
    """The body of ``sparse_build_rss``'s process: build phase (e)'s Dataset
    while a thread samples the RSS every 5 ms; prints the RSS resident
    before the build (imports, the CSR) and the largest sample, in bytes,
    as JSON."""
    import threading

    import lightgbm_tpu_torch as lt
    X, y = sparse_data()
    before = proc_status("VmRSS")
    peak = [before]
    done = threading.Event()

    def watch():
        while not done.wait(0.005):
            peak[0] = max(peak[0], proc_status("VmRSS"))
    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        lt.Dataset(X, label=y, params=SPARSE_PARAMS).construct()
    finally:
        done.set()
        watcher.join()
    peak[0] = max(peak[0], proc_status("VmRSS"))
    print(json.dumps({"before": before, "after": peak[0]}))


def sparse_build_rss():
    """Peak RSS of building phase (e)'s Dataset, in a process of its own
    (this one's high-water mark is the earlier phases'): the RSS resident
    before the build and the peak sampled during it, in bytes."""
    code = (f"import sys; sys.path.insert(0, {HERE!r}); "
            "import chip_smoke; chip_smoke.sparse_build_child()")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"sparse build process exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def sparse_phase(lt, kind, card):
    """(e) A CSR of 1,000,000 x 5,000 with 8 stored entries a row (the JAX
    package's ``tests/test_sparse.py`` wide shape and parameters at a
    million rows): the Dataset built without densifying (host seconds, the
    peak of host memory allocated meanwhile by tracemalloc, and the peak
    RSS of the same build in a process of its own), 3 rounds on the grower
    the JAX package's rule picks, then prediction from the CSR: the used
    columns gathered block by block and walked on the card (held against
    the host walk on the first rows)."""
    import tracemalloc

    from lightgbm_tpu_torch.core import forest
    rss = sparse_build_rss()
    X, y = sparse_data()
    n, f = X.shape
    params = SPARSE_PARAMS
    tracemalloc.start()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y, params=params).construct()
    build_s = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    h = ds._handle
    phys = h.phys_max_bins()
    wide = int((phys > 256).sum())
    dense_bytes = n * f * 8
    print(f"sparse Dataset ({n:,} x {f:,}, {X.nnz:,} stored entries): built "
          f"in {build_s:.2f} s (host), peak host memory allocated "
          f"{peak / 1e6:.1f} MB (tracemalloc), peak RSS during the build in "
          f"a process of its own (sampled every 5 ms) "
          f"{rss['after'] / 1e9:.3f} GB ("
          f"{rss['before'] / 1e9:.3f} GB resident before it: imports and "
          f"the CSR; the dense matrix would be {dense_bytes / 1e9:.0f} GB); "
          f"{h.num_features} features in "
          f"{len(phys)} physical columns ({wide} of more than 256 bins), "
          f"X_bin {h.X_bin.dtype} [{card}]", flush=True)
    if peak > dense_bytes / 10 or rss["after"] - rss["before"] > \
            dense_bytes / 10:
        raise AssertionError("the sparse Dataset was densified")
    t0 = time.perf_counter()
    bst = lt.train(params, ds, 3, device=DEV)
    train_s = time.perf_counter() - t0
    gb = bst._gbdt
    grower = ("wave (mixed width)" if gb.uses_wave and wide else
              "wave" if gb.uses_wave else "serial")
    before = dict(forest.calls)
    t0 = time.perf_counter()
    pred = bst.predict(X)
    pred_s = time.perf_counter() - t0
    ran = {k: forest.calls[k] - before[k] for k in before}
    # the first rows alone are below the device threshold: the host walk
    m = PREDICT_CHECK_ROWS
    host = bst.predict(X[:m])
    err = float(np.abs(pred[:m] - host).max())
    used = len(gb._sparse_window(0, gb.current_iteration())[0])
    gap = float(pred[y == 1].mean() - pred[y == 0].mean())
    print(f"sparse training: 3 rounds on the {grower} grower in "
          f"{train_s:.2f} s ({[t.num_leaves for t in gb.models]} leaves, "
          f"s/iter {gb.iter_seconds}); predict from the CSR {pred_s:.2f} s "
          f"({used} columns gathered; device forest calls {ran}), max "
          f"|probability - host walk| {err:.3g} on {m:,} rows (tol 1e-6), "
          f"mean prediction positives - negatives {gap:.4f} [{kind}, {card}]",
          flush=True)
    if ran["predict"] < 1:
        raise AssertionError(f"sparse predict: device forest calls {ran}")
    if pred.shape != (n,) or not np.all(np.isfinite(pred)) or gap <= 0.01 \
            or not err <= 1e-6:
        raise AssertionError("sparse predictions are not right")


def cli_more_phase(lt, kind, card, rows=200_000):
    """(f) The CLI on LibSVM input, in this process (``app.main``; phase 9
    runs it as a subprocess): a 200,000-row MSLR-shaped file (``qid:``
    tokens, 136 features numbered from 1, grades 0-4) through
    ``task=train objective=lambdarank`` gives the same trees with
    ``two_round=true`` as with ``two_round=false``; a binary LibSVM file
    with ``.weight`` and ``.init`` sidecars trains; ``input_model``
    continues its model; ``save_binary=true`` writes ``<data>.bin``, and
    training from that file gives the same model text."""
    import tempfile
    X, y, sizes = mslr_like(rows)
    n = X.shape[0]
    qid = np.repeat(np.arange(len(sizes)), sizes)
    walls = {}

    def cli(tag, *args):
        t0 = time.perf_counter()
        cli_train(["verbosity=-1", *args])
        walls[tag] = time.perf_counter() - t0

    def trees(path):
        with open(path) as fh:
            return fh.read().split("end of trees")[0]

    with tempfile.TemporaryDirectory() as d:
        rank = os.path.join(d, "rank.svm")
        t0 = time.perf_counter()
        fmt = ["%d", "qid:%d"] + [f"{j + 1}:%.6g" for j in range(136)]
        np.savetxt(rank, np.column_stack([y, qid, X]), fmt=fmt,
                   delimiter=" ")
        write_s = time.perf_counter() - t0
        common = ["num_trees=3", "num_leaves=255", "min_data_in_leaf=50",
                  "min_sum_hessian_in_leaf=5", "learning_rate=0.1"]
        for tr in ("false", "true"):
            cli(f"lambdarank two_round={tr}", f"data={rank}",
                "objective=lambdarank", f"two_round={tr}",
                f"output_model={os.path.join(d, f'rank_{tr}.txt')}",
                *common)
        same = trees(os.path.join(d, "rank_false.txt")) == trees(
            os.path.join(d, "rank_true.txt"))
        binary = os.path.join(d, "bin.svm")
        rng = np.random.default_rng(7)
        yb = (X[:, :8] @ rng.normal(size=8) + rng.logistic(size=n) > 0)
        np.savetxt(binary, np.column_stack([yb, X]),
                   fmt=["%d"] + [f"{j + 1}:%.6g" for j in range(136)],
                   delimiter=" ")
        np.savetxt(binary + ".weight", rng.uniform(0.5, 2.0, n), fmt="%.6g")
        np.savetxt(binary + ".init", rng.normal(size=n) * 0.1, fmt="%.6g")
        cli("binary + .weight + .init, save_binary", f"data={binary}",
            "objective=binary", "save_binary=true",
            f"output_model={os.path.join(d, 'b.txt')}", *common)
        cli("input_model continuation", f"data={binary}",
            "objective=binary", f"input_model={os.path.join(d, 'b.txt')}",
            f"output_model={os.path.join(d, 'c.txt')}", *common)
        cli("from the binary dataset file", f"data={binary}.bin",
            "objective=binary", f"output_model={os.path.join(d, 'b2.txt')}",
            *common)
        with open(os.path.join(d, "c.txt")) as fh:
            n_cont = fh.read().count("\nTree=")
        same_bin = trees(os.path.join(d, "b.txt")) == trees(
            os.path.join(d, "b2.txt"))
    print(f"CLI on LibSVM ({n:,} x 136, {len(sizes):,} queries; file "
          f"written in {write_s:.1f} s): walls "
          f"{ {k: round(v, 1) for k, v in walls.items()} } s; lambdarank "
          f"trees equal with two_round true/false: {same}; continued model "
          f"{n_cont} trees; trees from <data>.bin equal to the text's: "
          f"{same_bin} [{kind}, {card}]", flush=True)
    if not (same and same_bin and n_cont == 6):
        raise AssertionError("the CLI's LibSVM runs disagree")


# ---- the ninth slice: DART, RF, TreeSHAP, checkpoints, the guard, the
# oracles, convert_model (phases 15-21) --------------------------------------
SCRATCH = os.path.join(HERE, "build", "chip_smoke")
# drop_rate 0.1 with skip_drop 0 runs the drop step every iteration; with
# five trees the default drop_seed (4) happens to drop none, seed 37 drops
# 1, 0, 2, 1 trees in iterations 1-4 (and 1 in iteration 5)
DART = {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.0,
        "drop_seed": 37}
SHAP_ROWS = 100_000              # rows of the TreeSHAP pass on the card
SHAP_ORACLE_ROWS = 100           # rows held against the f64 recursion
# 20x fewer rows for the multiclass model: 7x the trees and paths ~3x as
# deep (P 29 against 11) as the main path's, so ~20x the work a row
SHAP_MULTICLASS_ROWS = 5_000
CONVERT_ROWS = 1_000


def trees_digest(bst) -> str:
    """The digest of the model text before its parameters block: equal
    trees under different parameter lists (the oracles' knobs)."""
    text = bst.model_to_string().split("\nparameters:")[0]
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def host_raw(bst, X):
    """Raw scores of the host walk of every tree (f64), [n, K]."""
    g = bst._gbdt
    return g._host_raw(np.ascontiguousarray(X, np.float64), g.models)


def dart_rf_phase(lt, hw, hc, params, ds, X, kind, card):
    """(15) DART: drop_rate 0.1, skip_drop 0 (a drop every iteration after
    the first), 5 rounds twice, one digest, train AUC > 0.7, the stacked-
    forest prediction of every row within 1e-4 of the host walk on the
    first rows after the rescales; xgboost_dart_mode 3 rounds.  (16) RF:
    bagging 0.632 every iteration, feature_fraction 0.8, 5 rounds twice,
    one digest, the prediction the average of the trees (host walk 1e-12,
    device walk 1e-5).  Returns the first runs' counts and s/iter."""
    from lightgbm_tpu_torch.core import forest
    n = PREDICT_CHECK_ROWS
    out = {}
    dart = {**params, **DART}
    runs = [train_phase(lt, hw, hc, f"DART path (run {i + 1})", dart, ds,
                        kind, card) for i in range(2)]
    bst, counts, curves, iter_ms = runs[0]
    drops = bst._gbdt.drops
    digests = [model_digest(r[0]) for r in runs]
    before = dict(forest.calls)
    raw = bst.predict(X, raw_score=True)
    ran = forest.calls["predict"] - before["predict"]
    err = float(np.abs(raw[:n] - host_raw(bst, X[:n])[:, 0]).max())
    print(f"DART: {iter_ms / 1e3:.4f} s/iter, trees dropped per iteration "
          f"{drops}, K1 launches {counts['k1']}, digests {digests}, train "
          f"AUC {curves['auc'][-1]:.4f}; stacked-forest predict (calls "
          f"{ran}) vs host walk after the rescales {err:.3g} (tol 1e-4) "
          f"[{kind}, {card}]", flush=True)
    if (digests[0] != digests[1] or curves["auc"][-1] <= 0.7 or ran != 1
            or err > 1e-4 or sum(drops[1:]) == 0):
        raise AssertionError("DART path failed its checks")
    out["dart"] = (counts, iter_ms)
    del runs, bst
    xgb, xcounts, _, xms = train_phase(
        lt, hw, hc, "DART xgboost_dart_mode", {**dart,
                                               "xgboost_dart_mode": True},
        ds, kind, card, rounds=3)
    print(f"DART xgboost_dart_mode: {xms / 1e3:.4f} s/iter, drops "
          f"{xgb._gbdt.drops}, K1 launches {xcounts['k1']} [{kind}, {card}]",
          flush=True)
    del xgb
    rf = {**params, "boosting": "rf", "bagging_fraction": 0.632,
          "bagging_freq": 1, "feature_fraction": 0.8}
    runs = [train_phase(lt, hw, hc, f"RF path (run {i + 1})", rf, ds, kind,
                        card) for i in range(2)]
    bst, counts, curves, iter_ms = runs[0]
    digests = [model_digest(r[0]) for r in runs]
    mean = np.mean([t.predict(X[:n]) for t in bst._gbdt.models], axis=0)
    host_err = float(np.abs(bst.predict(X[:n], raw_score=True) - mean).max())
    before = dict(forest.calls)
    raw = bst.predict(X, raw_score=True)
    ran = forest.calls["predict"] - before["predict"]
    dev_err = float(np.abs(raw[:n] - mean).max())
    print(f"RF: {iter_ms / 1e3:.4f} s/iter, K1 launches {counts['k1']}, "
          f"digests {digests}, train AUC {curves['auc'][-1]:.4f}; prediction "
          f"vs the average of the trees: host {host_err:.3g} (tol 1e-12), "
          f"stacked forest (calls {ran}) {dev_err:.3g} (tol 1e-5) "
          f"[{kind}, {card}]", flush=True)
    if (digests[0] != digests[1] or host_err > 1e-12 or dev_err > 1e-5
            or ran != 1):
        raise AssertionError("RF path failed its checks")
    out["rf"] = (counts, iter_ms)
    return out


def treeshap_phase(bst, X, name, rows, oracle_checks, kind, card):
    """(17) ``pred_contrib`` through the batched TreeSHAP pass on the card
    (``explain/``): the whole call by CUDA events, the pass alone (median
    of 3), its bound: ``ops/treeshap.py shap_cost`` summed over the trees,
    each at the path slots the pass runs for it (its ``max_slots``: the
    pass stops there, where ``shap_cost`` at the stacked P counts every
    padded slot), its FLOPs over the card's FP32 CUDA-core peak or its
    bytes over the memory rate, whichever is larger (the bound at the FP64
    peak, which stages 3-4 run at, is printed beside it); local accuracy
    (the contributions sum to the raw score within 1e-4); the f64 host
    recursion within 1e-5 for each (rows, (start, stop) iterations or
    None for all) of ``oracle_checks``.  Returns the treeshap line's
    entry."""
    import torch
    from lightgbm_tpu_torch.core.shap import predict_contrib as oracle
    from lightgbm_tpu_torch.explain import kernel
    from lightgbm_tpu_torch.ops.treeshap import shap_cost
    g = bst._gbdt
    K, F = g.num_tpi, X.shape[1]
    Xs = np.ascontiguousarray(X[:rows])
    calls0 = kernel.calls["shap"]
    contrib, call_ms = timed(lambda: bst.predict(Xs, pred_contrib=True))
    launches = kernel.calls["shap"] - calls0
    space, fst, explain, fn = g._contrib_cache
    bins = torch.from_numpy(space.bin_matrix(Xs)).to(fst.split_feature.device)
    pass_ms = cuda_ms(lambda: fn(fst, explain, bins), reps=3)
    T, L, P = explain.path_node.shape
    runs = [shap_cost(rows, 1, L, int(s), F, K) for s in explain.max_slots]
    flops, nbytes = sum(r[0] for r in runs), sum(r[1] for r in runs)
    padded_flops = shap_cost(rows, T, L, P, F, K)[0]
    b = bound(nbytes, flops)
    _, f32, f64 = peaks()
    b64 = bound(nbytes, flops * f32 / f64)
    raw = bst.predict(Xs, raw_score=True).reshape(rows, K)
    acc = float(np.abs(contrib.reshape(rows, K, F + 1).sum(-1) - raw).max())
    err, checked, host_s = 0.0, [], 0.0
    for n_rows, window in oracle_checks:
        start, stop = window or (0, g.current_iteration())
        dev = g._predict_contrib_device(Xs[:n_rows], start, stop)
        t0 = time.perf_counter()
        host = oracle(g, Xs[:n_rows], stop - start, start)
        host_s += time.perf_counter() - t0
        e = float(np.abs(dev - host).max())
        err = max(err, e)
        checked.append({"rows": n_rows, "window": [start, stop],
                        "max_abs_err": e})
    entry = {"name": f"treeshap ({name})", "route": "torch",
             "source": "lightgbm_tpu_torch/explain/kernel.py",
             "replaces": "lightgbm_tpu/explain/kernel.py:38 (XLA, no "
                         "pallas_call)",
             "launches": launches, "rows": rows, "trees": T, "L": L, "P": P,
             "slots_run": int(explain.max_slots.sum()),
             "call_ms": call_ms, "ms": pass_ms,
             "rows_per_s": rows / pass_ms * 1e3,
             "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "bound_fp64_peak_ms": b64["bound_ms"],
             "shap_flops": flops, "shap_flops_padded_P": padded_flops,
             "shap_bytes": nbytes, "local_accuracy": acc,
             "oracle": checked, "max_abs_err": err, "library_ms": None}
    where = ", ".join(f"{c['rows']} rows of iterations "
                      f"[{c['window'][0]}, {c['window'][1]}) "
                      f"{c['max_abs_err']:.3g}" for c in checked)
    print(f"TreeSHAP ({name}): {rows:,} rows x {T} trees, L {L}, P {P} "
          f"({entry['slots_run']} slots run over the trees): pred_contrib "
          f"call {call_ms:.2f} ms, the pass {pass_ms:.2f} ms "
          f"({rows / pass_ms * 1e3:,.0f} rows/s), shap_cost bound "
          f"{b['bound_ms']:.4f} ms (by {b['bound_by']}, FP32 peak; "
          f"{b64['bound_ms']:.4f} ms at the FP64 peak; {flops:.4g} FLOPs "
          f"for the slots run, {padded_flops:.4g} at the stacked P), "
          f"{pass_ms / b['bound_ms']:.1f}x the bound, device passes "
          f"{launches}; local accuracy {acc:.3g} (tol 1e-4); vs the f64 "
          f"recursion: {where} (tol 1e-5; host {host_s:.1f} s) "
          f"[{kind}, {card}]", flush=True)
    if launches != 1 or acc > 1e-4 or err > 1e-5 \
            or contrib.shape != (rows, K * (F + 1)):
        raise AssertionError(f"TreeSHAP ({name}) failed its checks")
    return entry


def resume_case(lt, hw, hc, name, params, ds, rounds, crash, kind, card):
    """One crash and resume: the uninterrupted run writes model text A
    with checkpoints every 3 rounds into a fresh directory; the directory
    is emptied, an injected ``raise`` at the device step of iteration
    ``crash`` ends the next run (DeviceWedgedError), and a rerun with the
    same directory resumes from its newest checkpoint and must write A
    byte for byte.  Returns (counts of the crashed and resumed runs, the
    checkpoints left by the crash, seconds of each run)."""
    import shutil
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.robust.watchdog import DeviceWedgedError
    d = os.path.join(SCRATCH, "ckpt")
    shutil.rmtree(d, ignore_errors=True)
    p = {**params, "tpu_checkpoint_dir": d, "tpu_checkpoint_freq": 3}
    t0 = time.perf_counter()
    text = lt.train(p, ds, rounds, device=DEV).model_to_string()
    straight_s = time.perf_counter() - t0
    shutil.rmtree(d)
    reset_counts(hw, hc)
    faults.configure(f"device_execute:raise@iter={crash}")
    t0 = time.perf_counter()
    try:
        lt.train(p, ds, rounds, device=DEV)
        raise AssertionError(f"{name}: the injected fault did not end the "
                             "run")
    except DeviceWedgedError:
        pass
    finally:
        faults.disarm()
    crash_s = time.perf_counter() - t0
    left = sorted(os.listdir(d))
    t0 = time.perf_counter()
    again = lt.train(p, ds, rounds, device=DEV).model_to_string()
    resume_s = time.perf_counter() - t0
    counts = read_counts(hw, hc)
    equal = again == text
    print(f"resume ({name}): crash at iteration {crash} left {left}; "
          f"resumed model text byte-equal to the uninterrupted run's: "
          f"{equal}; runs {straight_s:.2f} s straight, {crash_s:.2f} s to "
          f"the crash, {resume_s:.2f} s resumed; K1 launches (crash + "
          f"resume) {counts['k1']} [{kind}, {card}]", flush=True)
    if not equal:
        raise AssertionError(f"resume ({name}): model text differs")
    shutil.rmtree(d)
    return counts, left, (straight_s, crash_s, resume_s)


def resume_phase(lt, hw, hc, params, ds, kind, card):
    """(18) Checkpoint and resume on the headline rows: 2xbf16 with
    bagging 0.8, 10 rounds, a crash at iteration 7; DART, 6 rounds, a
    crash at iteration 4 (DART cannot roll back a half-applied iteration,
    so it resumes from the periodic checkpoint at 3); int16 with bagging,
    10 rounds (the stochastic rounding's seed survives); the time to write
    one checkpoint and to resume from it.  Returns the 2xbf16 counts."""
    import shutil
    from lightgbm_tpu_torch.robust.checkpoint import CheckpointManager
    bag = {**params, "bagging_fraction": 0.8, "bagging_freq": 1}
    counts, left, _ = resume_case(lt, hw, hc, "2xbf16 + bagging", bag, ds,
                                  10, 7, kind, card)
    if left != ["ckpt_00000003", "ckpt_00000006", "ckpt_00000007"]:
        raise AssertionError(f"unexpected checkpoints {left}")
    resume_case(lt, hw, hc, "DART", {**params, **DART}, ds, 6, 4, kind, card)
    resume_case(lt, hw, hc, "int16 + bagging",
                {**bag, "tpu_hist_dtype": "int16"}, ds, 10, 7, kind, card)
    d = os.path.join(SCRATCH, "ckpt_timing")
    shutil.rmtree(d, ignore_errors=True)
    p = {**bag, "tpu_checkpoint_dir": d}
    bst = lt.train(p, ds, 3, device=DEV)
    mgr = CheckpointManager.from_config(bst.config)
    t0 = time.perf_counter()
    path = mgr.save(bst, 3)
    save_ms = (time.perf_counter() - t0) * 1e3
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    fresh = lt.Booster(params=p, train_set=ds, device=DEV)
    t0 = time.perf_counter()
    mgr.resume(fresh, mgr.peek())
    resume_ms = (time.perf_counter() - t0) * 1e3
    print(f"checkpoint of 3 trees of 255 leaves at {ds.num_data():,} rows: "
          f"write "
          f"{save_ms:.1f} ms ({size:,} bytes), resume {resume_ms:.1f} ms "
          f"[{kind}, {card}]", flush=True)
    if model_digest(fresh) != model_digest(bst):
        raise AssertionError("a resumed booster's model differs")
    shutil.rmtree(d)
    return counts


def guard_phase(lt, params, ds, digest, kind, card):
    """(19) The device guard: a transient fault at the device step of
    iteration 2 is retried and the model is the main path's (digest); a
    fatal one under ``tpu_on_device_error=abort`` raises DeviceWedgedError
    and leaves the boundary checkpoint of iteration 2."""
    import shutil
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.robust.watchdog import DeviceWedgedError
    faults.configure("device_execute:transient@iter=2")
    try:
        bst = lt.train(params, ds, 5, device=DEV)
    finally:
        fired = faults.fired_counts()
        faults.disarm()
    retries = bst._gbdt._guard.retry_count
    same = model_digest(bst) == digest
    d = os.path.join(SCRATCH, "ckpt_abort")
    shutil.rmtree(d, ignore_errors=True)
    faults.configure("device_execute:raise@iter=2")
    try:
        lt.train({**params, "tpu_on_device_error": "abort",
                  "tpu_checkpoint_dir": d, "tpu_checkpoint_freq": 0},
                 ds, 5, device=DEV)
        raise AssertionError("the fatal fault did not raise")
    except DeviceWedgedError as exc:
        wedged = str(exc)
    finally:
        faults.disarm()
    left = sorted(os.listdir(d))
    print(f"device guard: transient at iteration 2 fired {fired}, retried "
          f"{retries}x, model = main path's: {same}; fatal under abort: "
          f"DeviceWedgedError ({wedged[:60]}...), checkpoints {left} "
          f"[{kind}, {card}]", flush=True)
    if not same or retries != 1 or left != ["ckpt_00000002"]:
        raise AssertionError("the device guard failed its checks")
    shutil.rmtree(d)


def oracle_phase(lt, hw, hc, params, ds, main_trees, main_ms, kind, card):
    """(20) The oracles on the headline rows, 5 rounds each:
    ``tpu_batched_split_apply=false`` and ``tpu_fused_grad=false`` grow the
    main path's trees (trees digest); ``tpu_wave_overlap`` "on" (the
    parameter) and "serial" (the grower's argument) one model between
    them.  s/iter of each beside the main path's.  Returns the overlap
    path's counts."""
    from lightgbm_tpu_torch.core.wave_grower import build_wave_grow_fn
    out = {"off": main_ms}
    for knob in ({"tpu_batched_split_apply": False},
                 {"tpu_fused_grad": False}):
        name = ", ".join(f"{k}={v}" for k, v in knob.items())
        bst, _, _, ms = train_phase(lt, hw, hc, f"oracle {name}",
                                    {**params, **knob}, ds, kind, card)
        out[name] = ms
        if trees_digest(bst) != main_trees:
            raise AssertionError(f"oracle {name}: other trees than the main "
                                 "path's")
        print(f"oracle {name}: trees digest {trees_digest(bst)} = main "
              f"path's; {ms / 1e3:.4f} s/iter [{kind}, {card}]", flush=True)
        if knob.get("tpu_batched_split_apply") is False:
            # one pass a split (core/wave_grower.py build_split_once_fn):
            # the split feature's u8 bin row read, the int32 leaf ids read
            # and written; the bound of a tree's splits at the HBM rate
            n = ds._handle.num_data
            splits = [t.num_leaves - 1 for t in bst._gbdt.models]
            per_split = n * (1 + 4 + 4)
            tree_ms = (per_split * float(np.mean(splits))
                       / peaks()[0] * 1e3)
            print(f"sequential split apply: {per_split / 1e6:.1f} MB a split "
                  f"x {float(np.mean(splits)):.0f} splits a tree = bound "
                  f"{tree_ms:.4f} ms a tree (bytes), against "
                  f"{ms - main_ms:.1f} ms a tree measured over the batched "
                  f"apply [{kind}, {card}]", flush=True)
    over = {**params, "tpu_wave_overlap": True}
    on, counts_on, _, on_ms = train_phase(lt, hw, hc, "overlap on", over,
                                          ds, kind, card)
    reset_counts(hw, hc)
    serial = lt.Booster(params=dict(over), train_set=ds, device=DEV)
    g = serial._gbdt
    g._grow = build_wave_grow_fn(**{**g.wave_kw, "overlap": "serial"})
    for _ in range(5):
        serial.update()
    counts_serial = read_counts(hw, hc)
    serial_ms = float(np.median(g.iter_seconds[1:])) * 1e3
    out.update(on=on_ms, serial=serial_ms)
    print(f"overlap: digests on {model_digest(on)} / serial "
          f"{model_digest(serial)}; s/iter off {main_ms / 1e3:.4f}, on "
          f"{on_ms / 1e3:.4f}, serial {serial_ms / 1e3:.4f}; K1 launches on "
          f"{counts_on['k1']}, serial {counts_serial['k1']}; s/iter by "
          f"oracle {json.dumps({k: v / 1e3 for k, v in out.items()})} "
          f"[{kind}, {card}]", flush=True)
    if model_digest(on) != model_digest(serial) or counts_serial["k1"] == 0:
        raise AssertionError("overlap on and serial grew other trees")
    return counts_on


_C_HARNESS = r"""
#include <stdio.h>
#include <stdlib.h>
#ifdef __cplusplus
extern "C"
#endif
void PredictRaw(const double* row, double* output);
int main(int argc, char** argv) {
  int n = atoi(argv[2]), f = atoi(argv[3]), k = atoi(argv[4]);
  FILE* fh = fopen(argv[1], "rb");
  double* row = (double*)malloc(sizeof(double) * f);
  double* out = (double*)malloc(sizeof(double) * k);
  for (int i = 0; i < n; ++i) {
    if (fread(row, sizeof(double), f, fh) != (size_t)f) return 1;
    PredictRaw(row, out);
    for (int j = 0; j < k; ++j) printf("%.17g\n", out[j]);
  }
  return 0;
}
"""


def convert_phase(bst, X, kind, card):
    """(21) ``task=convert_model``: the CLI converts the main path's model
    file to C; the host C compiler (the one nvcc calls) builds it with a
    small reader, which scores rows within 1e-10 of
    ``predict(raw_score=True)``."""
    import shutil
    d = os.path.join(SCRATCH, "convert")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    model = os.path.join(d, "model.txt")
    bst.save_model(model)
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                    "task=convert_model", f"input_model={model}",
                    f"convert_model={os.path.join(d, 'model.c')}"],
                   check=True, env=env, timeout=300)
    convert_s = time.perf_counter() - t0
    cc = shutil.which("gcc") or shutil.which("cc") or shutil.which("g++")
    if cc is None:
        raise AssertionError("no host C compiler found")
    rows = np.ascontiguousarray(X[:CONVERT_ROWS], np.float64)
    rows.tofile(os.path.join(d, "rows.bin"))
    with open(os.path.join(d, "main.c"), "w") as fh:
        fh.write(_C_HARNESS)
    exe = os.path.join(d, "score")
    t0 = time.perf_counter()
    lang = ["-x", "c++"] if cc.endswith("++") else []
    subprocess.run([cc, "-O1", *lang, "-o", exe, os.path.join(d, "model.c"),
                    os.path.join(d, "main.c"), "-lm"], check=True,
                   timeout=600)
    build_s = time.perf_counter() - t0
    out = subprocess.run([exe, os.path.join(d, "rows.bin"), str(len(rows)),
                          str(rows.shape[1]), "1"], check=True,
                         capture_output=True, text=True, timeout=300).stdout
    got = np.asarray(out.split(), np.float64)
    err = float(np.abs(got - bst.predict(rows, raw_score=True)).max())
    size = os.path.getsize(os.path.join(d, "model.c"))
    print(f"convert_model: CLI {convert_s:.2f} s ({size:,} bytes of C), "
          f"{os.path.basename(cc)} build {build_s:.2f} s, {len(rows):,} rows "
          f"scored within {err:.3g} of predict(raw_score=True) (tol 1e-10) "
          f"[{kind}, {card}]", flush=True)
    if got.shape != (len(rows),) or err > 1e-10:
        raise AssertionError("the converted model scores differently")
    shutil.rmtree(d)


# ---- 22-26: serving on the card ------------------------------------------
SERVE_ROUNDS = 100               # the served model: 100 rounds, 255 leaves
SERVE_CHECK_ROWS = 100_000       # rows through the session vs the Booster
SERVE_HOST_ROWS = 2_000          # of them, held against the f64 host walk
SERVE_BUCKETS = (1, 8, 64, 256, 1024)
SERVE_CALLS = 200                # sync calls per bucket for p50/p99
SERVE_CLIENTS = 8
SERVE_REQUESTS = 100             # per client thread
SERVE_POOL = 20_000              # rows the fleet's requests are cut from
SERVE_SWAP_REQUESTS = 25         # per client, in the hot-swap run


def pct(vals, p):
    """Nearest-rank percentile (the serving stack's definition)."""
    v = sorted(vals)
    return v[min(max(math.ceil(p * len(v)) - 1, 0), len(v) - 1)] if v else None


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(url, payload=None, timeout=120):
    """(status, body, headers) of one request; JSON bodies decoded."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, body, hdr = resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        code, body, hdr = exc.code, exc.read(), dict(exc.headers)
    text = body.decode()
    return code, (json.loads(text) if text.startswith("{") else text), hdr


def serve_model_phase(lt, hw, hc, params, ds, kind, card):
    """(22, set-up) The served model: 100 rounds of 255 leaves (2xbf16) on
    the headline Dataset, counts zeroed first; saved to a file (the phases
    serve it from the file) with its 50-iteration cut (the hot swap's
    target).  Returns (path, path of the cut, seconds)."""
    reset_counts(hw, hc)
    t0 = time.perf_counter()
    bst = lt.train(params, ds, num_boost_round=SERVE_ROUNDS, device=DEV)
    train_s = time.perf_counter() - t0
    counts = read_counts(hw, hc)
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "serve_model.txt")
    cut = os.path.join(SCRATCH, "serve_model_50.txt")
    bst.save_model(path)
    bst.save_model(cut, num_iteration=50)
    print(f"serve model: {SERVE_ROUNDS} rounds of 255 leaves in "
          f"{train_s:.2f} s ({train_s / SERVE_ROUNDS:.4f} s/iter), K1 "
          f"launches {counts['k1']}; saved {os.path.getsize(path):,} bytes "
          f"[{kind}, {card}]", flush=True)
    if len(bst._gbdt.models) != SERVE_ROUNDS or counts["k1"] == 0:
        raise AssertionError("the served model did not train")
    return path, cut


def predict_routes_phase(lt, model, X, kind, card):
    """(22, set-up) ``task=predict``'s two routes on every headline row
    (1M rows x 100 trees): ``Booster.predict`` and the
    ``PredictorSession`` that heavy work takes (``app.py run_predict``),
    each warmed on 20,000 rows, then timed booster, session, session,
    booster (host clock, result on the host); they agree within 1e-6.
    Returns the phase's seconds."""
    from lightgbm_tpu_torch.serve import PredictorSession
    t_phase = time.perf_counter()
    bst = lt.Booster(model_file=model, device=DEV)
    with PredictorSession(bst, config=bst.config, device=DEV) as sess:
        bst.predict(X[:20_000])
        sess.predict(X[:20_000])
        ms = {"booster": [], "session": []}
        out = {}
        for route in ("booster", "session", "session", "booster"):
            fn = bst.predict if route == "booster" else sess.predict
            t0 = time.perf_counter()
            out[route] = fn(X)
            ms[route].append(round((time.perf_counter() - t0) * 1e3, 3))
    err = float(np.abs(out["session"] - out["booster"]).max())
    print(f"task=predict routes ({X.shape[0]:,} rows x {SERVE_ROUNDS} "
          f"trees, {DEV}; booster, session, session, booster): "
          f"Booster.predict {ms['booster']} ms, PredictorSession.predict "
          f"{ms['session']} ms; max |session - booster| {err:.3g} (tol "
          f"1e-6) [{kind}, {card}]", flush=True)
    if err > 1e-6 or out["session"].shape != (X.shape[0],):
        raise AssertionError("the two task=predict routes disagree")
    return time.perf_counter() - t_phase


def session_phase(lt, model, X, kind, card):
    """(22) ``PredictorSession(model_file)`` on the card: ``warmup()`` over
    every bucket up to 1,024; 100,000 rows against
    ``Booster(model_file).predict`` (its stacked-forest walk) within 1e-6,
    and 2,000 of them (raw) against the session's f64 host walk within
    1e-6; p50/p99 of ``SERVE_CALLS`` sync calls per bucket, host clock,
    result on the host."""
    from lightgbm_tpu_torch.serve import PredictorSession
    t0 = time.perf_counter()
    sess = PredictorSession(model, device=DEV)
    pack_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        n_buckets = sess.warmup()
        warm_s = time.perf_counter() - t0
        rows = X[:SERVE_CHECK_ROWS]
        t0 = time.perf_counter()
        got = sess.predict(rows)
        big_s = time.perf_counter() - t0
        want = lt.Booster(model_file=model).predict(rows)
        err = float(np.abs(got - want).max())
        host = rows[:SERVE_HOST_ROWS]
        host_err = float(np.abs(sess.predict(host, raw_score=True)
                                - sess._run_host(host)[:, 0]).max())
        lat = {}
        for b in SERVE_BUCKETS:
            chunk = X[:b]
            ms = []
            for _ in range(SERVE_CALLS):
                t0 = time.perf_counter()
                sess.predict(chunk)
                ms.append((time.perf_counter() - t0) * 1e3)
            lat[b] = {"p50_ms": round(pct(ms, 0.5), 3),
                      "p99_ms": round(pct(ms, 0.99), 3),
                      "rows_per_s": round(b / pct(ms, 0.5) * 1e3)}
        st = sess.stats()
    finally:
        sess.close()
    print(f"session ({SERVE_ROUNDS} trees, {DEV}): packed in {pack_s:.2f} s, "
          f"warmup of {n_buckets} buckets {warm_s:.2f} s; "
          f"{SERVE_CHECK_ROWS:,} rows in {big_s * 1e3:.1f} ms "
          f"({SERVE_CHECK_ROWS / big_s:,.0f} rows/s), max |session - "
          f"Booster.predict| {err:.3g} (tol 1e-6), max |raw - f64 host "
          f"walk| {host_err:.3g} over {SERVE_HOST_ROWS:,} rows (tol 1e-6); "
          f"per bucket (sync "
          f"predict, host clock, {SERVE_CALLS} calls): {json.dumps(lat)}; "
          f"buckets {st['buckets']} [{kind}, {card}]", flush=True)
    if err > 1e-6 or host_err > 1e-6 or st["degraded"] or n_buckets != 11:
        raise AssertionError("the serving session disagrees with "
                             "Booster.predict")
    return lat


def fleet_stack(model, **over):
    """``run_serve``'s stack in process: a registry with 2 replicas on the
    card, the arena attached, the HTTP server on a free port."""
    from lightgbm_tpu_torch.serve import (ForestArena, ModelRegistry,
                                          PredictServer)
    cfg = {"tpu_serve_replicas": 2, "tpu_serve_rollback_watch_s": 0,
           "verbose": -1, **over}
    reg = ModelRegistry(config=cfg, device=DEV)
    reg.add_model("default", model)
    reg.attach_arena(ForestArena(config=cfg, device=DEV))
    reg.resolve(None).router.warmup()
    return reg, PredictServer(reg, port=free_port()).start()


def traffic(url, pool, refs, clients, requests, seed, on_reply=None):
    """``clients`` threads, ``requests`` each: 1-256 rows cut from
    ``pool``, priorities mixed.  Each reply is held against the reference
    of the version it names (``refs``: version -> predictions of the
    pool) within 1e-6.  Returns (latencies ms, status counts, versions,
    mismatches)."""
    import threading
    lat, status, versions, bad = [], {}, {}, []
    lock = threading.Lock()

    def client(i):
        rng = np.random.default_rng(seed + i)
        for _ in range(requests):
            n = int(rng.integers(1, 257))
            lo = int(rng.integers(0, len(pool) - n))
            prio = ("high", "normal", "low")[int(rng.integers(0, 3))]
            t0 = time.perf_counter()
            code, body, _ = http(url + "/predict",
                                 {"rows": pool[lo:lo + n].tolist(),
                                  "priority": prio})
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(ms)
                status[code] = status.get(code, 0) + 1
                if code == 200:
                    v = body["version"]
                    versions[v] = versions.get(v, 0) + 1
                    err = float(np.abs(np.asarray(body["predictions"])
                                       - refs[v][lo:lo + n]).max())
                    if err > 1e-6:
                        bad.append((v, lo, n, err))
            if on_reply is not None:
                on_reply()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a traffic client did not finish")
    return lat, status, versions, bad


def fleet_phase(lt, model, cut, X, kind, card):
    """(23) The fleet over HTTP: 8 clients x 100 requests of 1-256 rows,
    every reply within 1e-6 of ``Booster.predict``; p50/p99 (client
    clock), served and shed, occupancy and pad waste; ``POST /explain`` of
    64 rows summing to the raw score within 1e-4; a hot swap of
    ``default`` to the 50-iteration cut under traffic (no failed request,
    every reply one version's), then a rollback."""
    import threading
    pool = np.ascontiguousarray(X[:SERVE_POOL])
    refs = {1: lt.Booster(model_file=model).predict(pool),
            2: lt.Booster(model_file=cut).predict(pool)}
    reg, server = fleet_stack(model)
    try:
        t0 = time.perf_counter()
        lat, status, versions, bad = traffic(
            server.url, pool, refs, SERVE_CLIENTS, SERVE_REQUESTS, 100)
        wall = time.perf_counter() - t0
        st = reg.resolve(None).router.stats()
        snap = reg.resolve(None).router.metrics.snapshot()
        n_req = SERVE_CLIENTS * SERVE_REQUESTS
        print(f"fleet over HTTP (2 replicas on {DEV}, {SERVE_CLIENTS} "
              f"clients x {SERVE_REQUESTS} requests of 1-256 rows): "
              f"{n_req / wall:,.0f} requests/s, {st['rows'] / wall:,.0f} "
              f"rows/s; client p50 {pct(lat, 0.5):.2f} ms, p99 "
              f"{pct(lat, 0.99):.2f} ms; status {status}; served by "
              f"priority {snap['served_by_priority']}, shed "
              f"{snap['shed_by_priority']}; batches {st['batches']}, "
              f"occupancy {st['occupancy']}, pad waste "
              f"{st['padded_rows'] - st['rows']:,} rows, buckets "
              f"{st['buckets']}; session p50 {st['p50_ms']} p99 "
              f"{st['p99_ms']} ms [{kind}, {card}]", flush=True)
        if bad or status != {200: n_req} or versions != {1: n_req}:
            raise AssertionError(f"fleet replies wrong: status {status}, "
                                 f"mismatches {bad[:3]}")
        rows64 = pool[:64]
        t0 = time.perf_counter()
        code, body, _ = http(server.url + "/explain",
                             {"rows": rows64.tolist()})
        explain_ms = (time.perf_counter() - t0) * 1e3
        raw = lt.Booster(model_file=model).predict(rows64, raw_score=True)
        contrib = np.asarray(body["contributions"])
        sum_err = float(np.abs(contrib.sum(1) - raw).max())
        print(f"POST /explain (64 rows x {SERVE_ROUNDS} trees): "
              f"{explain_ms:.1f} ms; contributions sum to the raw score "
              f"within {sum_err:.3g} (tol 1e-4) [{kind}, {card}]", flush=True)
        if code != 200 or contrib.shape != (64, 29) or sum_err > 1e-4:
            raise AssertionError("POST /explain failed or does not sum")
        # the hot swap under traffic
        swap = {}
        done = [0]
        lock = threading.Lock()

        def on_reply():
            with lock:
                done[0] += 1
                go = done[0] == SERVE_CLIENTS * SERVE_SWAP_REQUESTS // 3
            if go:
                t1 = time.perf_counter()
                swap["reply"] = http(server.url + "/models/default/swap",
                                     {"model_file": cut})
                swap["ms"] = (time.perf_counter() - t1) * 1e3

        lat2, status2, versions2, bad2 = traffic(
            server.url, pool, refs, SERVE_CLIENTS, SERVE_SWAP_REQUESTS, 200,
            on_reply=on_reply)
        code_s, rep, _ = swap["reply"]
        code_r, rb, _ = http(server.url + "/models/default/rollback",
                             {"reason": "chip_smoke"})
        code_p, after, _ = http(server.url + "/predict",
                                {"rows": pool[:8].tolist()})
        n2 = SERVE_CLIENTS * SERVE_SWAP_REQUESTS
        print(f"hot swap under traffic ({SERVE_CLIENTS} x "
              f"{SERVE_SWAP_REQUESTS} requests): swap to the 50-iteration "
              f"cut {code_s} in {swap['ms']:.0f} ms (canary "
              f"{rep.get('canary', {}).get('checks')}, p99 "
              f"{rep.get('canary', {}).get('p99_ms')} ms); replies by "
              f"version {versions2}, status {status2}, mismatches "
              f"{len(bad2)}; client p99 {pct(lat2, 0.99):.2f} ms; rollback "
              f"{code_r} -> v{rb.get('to_version')}, then a reply from "
              f"v{after.get('version')} [{kind}, {card}]", flush=True)
        if (code_s != 200 or bad2 or status2 != {200: n2}
                or set(versions2) != {1, 2} or code_r != 200
                or after.get("version") != 1
                or not np.allclose(after["predictions"], refs[1][:8],
                                   rtol=0, atol=1e-6)):
            raise AssertionError("the hot swap lost or mixed replies")
    finally:
        server.stop(close_session=True)
    return {"p50_ms": pct(lat, 0.5), "p99_ms": pct(lat, 0.99),
            "occupancy": st["occupancy"]}


def arena_phase(lt, tenants, kind, card):
    """(24) The arena: the served model, phase 12's multiclass model and
    phase 14's weighted regression model as three tenants; mixed-tenant
    batches bit-equal to each tenant's solo session on the card; a byte
    budget that holds two tenants evicts one, which is re-admitted on its
    next request, bit-equal again."""
    from lightgbm_tpu_torch.serve import ForestArena, PredictorSession
    solo = {n: PredictorSession(p, device=DEV) for n, p, _ in tenants}
    try:
        arena = ForestArena(device=DEV, max_wait_ms=5.0)
        try:
            t0 = time.perf_counter()
            for n, p, _ in tenants:
                arena.admit(n, p)
            admit_s = time.perf_counter() - t0
            full = arena.stats()["packed_bytes"]
            tickets = []
            for r in range(8):
                for n, _, X in tenants:
                    chunk = X[r * 97:r * 97 + 97]
                    tickets.append((n, chunk, arena.submit(chunk, model=n)))
            t0 = time.perf_counter()
            equal = all(np.array_equal(arena.result(t, timeout=120),
                                       solo[n].predict(c))
                        for n, c, t in tickets)
            mixed_s = time.perf_counter() - t0
            sync_equal = all(np.array_equal(arena.predict(X[:1000], model=n),
                                            solo[n].predict(X[:1000]))
                             for n, _, X in tenants)
            st = arena.stats()
        finally:
            arena.close()
        budget = ForestArena(device=DEV, budget_bytes=full - 1)
        try:
            for n, p, _ in tenants:
                budget.admit(n, p)
            st_b = budget.stats()
            evicted = [t["name"] for t in budget.tenants()
                       if not t["resident"]]
            n0, _, X0 = next(t for t in tenants if t[0] == evicted[0])
            back = np.array_equal(budget.predict(X0[:1000], model=n0),
                                  solo[n0].predict(X0[:1000]))
            st_r = budget.stats()
        finally:
            budget.close()
    finally:
        for s in solo.values():
            s.close()
    print(f"arena (3 tenants: {[n for n, _, _ in tenants]}, {DEV}): admitted "
          f"in {admit_s:.2f} s, {full:,} packed bytes; {len(tickets)} "
          f"mixed-tenant requests in {st['batches']} batches "
          f"({st['cross_model_batches']} cross-model), bit-equal to the "
          f"solo sessions {equal} ({mixed_s * 1e3:.0f} ms), sync {sync_equal};"
          f" budget {full - 1:,} bytes: resident {st_b['resident']}, "
          f"evicted {evicted}, re-admitted on its next request "
          f"(readmissions {st_r['readmissions']}, evictions "
          f"{st_r['evictions']}) bit-equal {back} [{kind}, {card}]",
          flush=True)
    if not (equal and sync_equal and back and st["cross_model_batches"] >= 1
            and st_b["resident"] == 2 and len(evicted) == 1
            and st_r["readmissions"] == 1):
        raise AssertionError("the arena disagrees with its solo sessions")


def fault_phase(lt, model, X, kind, card):
    """(25) Device faults in the fleet over HTTP: ``serve_replica_0`` wedged
    (every request answered by r1, r0's breaker open on /health), then
    half-open and closed once the fault stops; one ``serve_device`` fault
    (that request a 503 with Retry-After, the replica degraded, the sibling
    answering, the device re-probed and recovered).  No reply comes from
    the host: every 200 equals a solo session's device answer bit for
    bit (the host walk sums in f64 and would differ)."""
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.serve import PredictorSession
    pool = np.ascontiguousarray(X[:4096])
    with PredictorSession(model, device=DEV) as solo:
        ref = solo.predict(pool)      # the device walk's bits
    reg, server = fleet_stack(model, tpu_serve_reprobe_s=0.5,
                              tpu_serve_breaker_backoff_s=0.2)
    url = server.url
    out = {}

    def ask(n=64):
        code, body, hdr = http(url + "/predict", {"rows": pool[:n].tolist()})
        ok = (code != 200 or np.array_equal(body["predictions"], ref[:n]))
        return code, body, hdr, ok

    try:
        faults.configure("serve_replica_0:raise@n=-1")
        replies = [ask() for _ in range(40)]
        health = http(url + "/health")[1]
        r0 = health["replicas"][0]
        out["wedged"] = {
            "replicas": sorted({b.get("replica") for c, b, _, _ in replies
                                if c == 200}),
            "status": sorted({c for c, _, _, _ in replies}),
            "r0_breaker": r0["breaker"]["state"], "r0_healthy": r0["healthy"]}
        faults.disarm()
        t0 = time.perf_counter()
        while (reg.resolve(None).router.replicas[0].breaker.state != "closed"
               and time.perf_counter() - t0 < 30):
            replies.append(ask())
            time.sleep(0.05)
        out["closed_after_s"] = round(time.perf_counter() - t0, 3)
        out["r0_breaker_after"] = \
            reg.resolve(None).router.replicas[0].breaker.state
        faults.configure("serve_device:raise@n=1")
        code, body, hdr, _ = ask()
        h2 = http(url + "/health")[1]
        faults.disarm()
        out["device_fault"] = {"status": code, "error": body.get("error"),
                               "retry_after": hdr.get("Retry-After"),
                               "any_degraded": h2["any_degraded"]}
        more = [ask() for _ in range(20)]
        t0 = time.perf_counter()
        while (reg.resolve(None).router.stats()["any_degraded"]
               and time.perf_counter() - t0 < 30):
            more.append(ask())
            time.sleep(0.05)
        st = reg.resolve(None).router.stats()
        out["recovered_after_s"] = round(time.perf_counter() - t0, 3)
        out["recoveries"] = st["recoveries"]
        replies += more
    finally:
        faults.disarm()
        server.stop(close_session=True)
    from_host = sum(1 for c, _, _, ok in replies if not ok)
    out["replies_200"] = sum(1 for c, _, _, _ in replies if c == 200)
    out["not_the_device_answer"] = from_host
    print(f"device faults over HTTP: {json.dumps(out)} [{kind}, {card}]",
          flush=True)
    w, d = out["wedged"], out["device_fault"]
    if not (w["replicas"] == ["r1"] and w["status"] == [200]
            and w["r0_breaker"] in ("open", "half_open")
            and not w["r0_healthy"]
            and out["r0_breaker_after"] == "closed"
            and d["status"] == 503 and d["error"] == "device_failed"
            and d["retry_after"] and d["any_degraded"]
            and out["recoveries"] == 1 and from_host == 0
            and all(c == 200 for c, _, _, _ in more)):
        raise AssertionError(f"the fleet's fault handling is wrong: {out}")


def serve_cli_phase(lt, model, X, kind, card):
    """(26) ``python -m lightgbm_tpu_torch task=serve`` as a subprocess on
    the card: /health "ok", ``POST /predict`` of 1,000 rows within 1e-6 of
    ``Booster.predict``, then SIGINT: a clean exit within 10 s."""
    import signal
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         f"input_model={model}", f"tpu_serve_port={port}"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    url = f"http://127.0.0.1:{port}"
    try:
        health = None
        while time.perf_counter() - t0 < 180 and proc.poll() is None:
            try:
                code, health, _ = http(url + "/health", timeout=5)
                if code == 200:
                    break
            except OSError:
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        if proc.poll() is not None or not health \
                or health.get("status") != "ok":
            raise AssertionError(f"task=serve did not come up: {health}")
        rows = X[:1000]
        code, body, _ = http(url + "/predict", {"rows": rows.tolist()})
        err = float(np.abs(np.asarray(body["predictions"])
                           - lt.Booster(model_file=model).predict(rows)).max())
    finally:
        t1 = time.perf_counter()
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            _, stderr = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError("task=serve did not exit within 10 s of "
                                 "SIGINT")
    stop_s = time.perf_counter() - t1
    print(f"CLI task=serve: /health ok after {up_s:.1f} s (devices "
          f"{sorted({r['device'] for r in health['replicas']})}), POST "
          f"/predict of 1,000 rows {code}, max |reply - Booster.predict| "
          f"{err:.3g} (tol 1e-6); SIGINT -> exit {proc.returncode} in "
          f"{stop_s:.2f} s [{kind}, {card}]", flush=True)
    if code != 200 or err > 1e-6 or proc.returncode != 0:
        raise AssertionError(f"task=serve failed: {stderr[-2000:]}")


# ---- 27-28: the Python API and observability on the card ------------------

API_CHECK_ROWS = 100_000         # rows predicted through the copies
PANDAS_ROWS = 200_000            # rows of the DataFrame with a category
DRIFT_ROWS = 20_000              # served rows, in distribution and shifted


def sklearn_api_phase(lt, hw, hc, X, y, main_trees, kind, card):
    """(27) ``LGBMClassifier().fit`` on the headline rows, 5 rounds at 255
    leaves (the main path's parameters, counts zeroed first): its model
    equals ``lt.train``'s on the parameters the estimator passes (one
    digest), and its trees the main path's.  Then, on the card-trained
    booster: a pickle and a ``deepcopy`` round trip, predictions on
    ``API_CHECK_ROWS`` rows bit-equal; ``trees_to_dataframe`` with one row
    a node; ``plot_importance`` and ``plot_tree`` to files (Agg; the tree
    through graphviz's ``dot`` where it is installed, else its digraph
    source); and a pandas DataFrame of ``PANDAS_ROWS`` rows with a
    category column trained and predicted, its categories kept through
    the model text.  The pandas and the matplotlib steps each run where
    their package is installed (host work: no card in them) and say so
    where it is not.  Returns (K1 counts of the fit, seconds)."""
    import copy
    import importlib.util
    import pickle
    missing = [m for m in ("pandas", "matplotlib")
               if importlib.util.find_spec(m) is None]
    t0 = time.perf_counter()
    reset_counts(hw, hc)
    clf = lt.LGBMClassifier(n_estimators=5, num_leaves=255,
                            learning_rate=0.1, max_bin=255,
                            min_child_samples=100, verbose=-1)
    t_fit = time.perf_counter()
    clf.fit(X, y)
    fit_s = time.perf_counter() - t_fit
    counts = read_counts(hw, hc)
    bst = clf.booster_
    if bst.device.type != DEV or counts["k1"] == 0:
        raise AssertionError(f"the estimator did not train on the card: "
                             f"{bst.device}, {counts}")
    p = dict(bst.params)
    ref = lt.train(p, lt.Dataset(X, label=y.astype(np.float64), params=p),
                   num_boost_round=5)
    est_digest, ref_digest = model_digest(bst), model_digest(ref)
    del ref
    Xc = X[:API_CHECK_ROWS]
    want = clf.predict_proba(Xc)
    pickled = pickle.loads(pickle.dumps(clf))
    dup = copy.deepcopy(bst)
    pickle_err = float(np.abs(pickled.predict_proba(Xc) - want).max())
    copy_err = float(np.abs(dup.predict(Xc) - want[:, 1]).max())
    if dup.device.type != DEV:
        raise AssertionError("the deep copy left the card")
    print(f"API: LGBMClassifier.fit on {X.shape[0]:,} x {X.shape[1]} in "
          f"{fit_s:.2f} s, K1 launches {counts['k1']}; model digest "
          f"{est_digest} = lt.train's {ref_digest}; trees digest "
          f"{trees_digest(bst)} (main path {main_trees}); pickle "
          f"|diff| {pickle_err!r}, deepcopy |diff| {copy_err!r} over "
          f"{API_CHECK_ROWS:,} rows [{kind}, {card}]", flush=True)
    if est_digest != ref_digest:
        raise AssertionError("the estimator's model differs from lt.train's")
    if pickle_err != 0.0 or copy_err != 0.0:
        raise AssertionError("a pickled or copied booster predicts "
                             "otherwise")
    if missing:
        print(f"API: not installed on this machine: {', '.join(missing)}; "
              f"the steps that need it are not run (host work: no card in "
              f"them; tests/test_torch_api.py and test_torch_plotting.py run "
              f"them on the CPU) [{kind}, {card}]", flush=True)
    if "matplotlib" not in missing:
        api_plots(lt, bst, kind, card)
    if "pandas" not in missing:
        api_pandas(lt, bst, X, y, kind, card)
    return counts, time.perf_counter() - t0


def api_plots(lt, bst, kind, card):
    """Phase 27's plots to files: the importance bars, and tree 0 (through
    graphviz's ``dot`` where it is installed, else its digraph source)."""
    import matplotlib
    matplotlib.use("Agg")
    os.makedirs(SCRATCH, exist_ok=True)
    imp_png = os.path.join(SCRATCH, "importance.png")
    lt.plot_importance(bst).figure.savefig(imp_png)
    tree_file = os.path.join(SCRATCH, "tree0.png")
    try:
        lt.plot_tree(bst, tree_index=0).figure.savefig(tree_file)
        tree_how = "plot_tree"
    except Exception as exc:  # noqa: BLE001 — no graphviz on the host
        tree_file = os.path.join(SCRATCH, "tree0.gv")
        with open(tree_file, "w") as fh:
            fh.write(lt.create_tree_digraph(bst, tree_index=0).source)
        tree_how = f"digraph source ({type(exc).__name__}: {exc})"
    print(f"API: plot_importance -> {os.path.getsize(imp_png)} bytes, tree 0"
          f" by {tree_how} -> {os.path.getsize(tree_file)} bytes "
          f"[{kind}, {card}]", flush=True)


def api_pandas(lt, bst, X, y, kind, card):
    """Phase 27's pandas steps: one ``trees_to_dataframe`` row a node, and
    a DataFrame with a category column trained on the card and predicted,
    its categories kept through the model text."""
    import pandas as pd
    df = bst.trees_to_dataframe()
    nodes = sum(2 * t.num_leaves - 1 for t in bst._gbdt.models)
    # the first column cut into 8 named categories
    n = PANDAS_ROWS
    cut = np.digitize(X[:n, 0], np.quantile(X[:n, 0], np.linspace(
        0, 1, 9)[1:-1]))
    frame = pd.DataFrame(X[:n, 1:], columns=[f"f{i}" for i in range(1, 28)])
    frame["c0"] = pd.Categorical(np.asarray(list("abcdefgh"))[cut])
    pp = {"objective": "binary", "num_leaves": 63, "verbose": -1}
    pbst = lt.train(pp, lt.Dataset(frame, label=y[:n], params=pp),
                    num_boost_round=5)
    ppred = pbst.predict(frame)
    re = lt.Booster(model_str=pbst.model_to_string())
    pandas_err = float(np.abs(re.predict(frame) - ppred).max())
    print(f"API: trees_to_dataframe {len(df)} rows for {nodes} nodes; "
          f"DataFrame {n:,} x 28 with a category column: categories "
          f"{pbst.pandas_categorical}, train AUC {auc_of(ppred, y[:n]):.4f},"
          f" model-text round trip |diff| {pandas_err!r} [{kind}, {card}]",
          flush=True)
    if len(df) != nodes or not df.node_index.is_unique:
        raise AssertionError("trees_to_dataframe is not one row a node")
    if pandas_err != 0.0 or re.pandas_categorical != [list("abcdefgh")] \
            or pbst.feature_name()[-1] != "c0":
        raise AssertionError("pandas categories did not survive the model "
                             "text")


def auc_of(pred, label) -> float:
    """Rank AUC of binary labels (no ties expected)."""
    order = np.argsort(pred, kind="stable")
    ranks = np.empty(len(pred))
    ranks[order] = np.arange(1, len(pred) + 1)
    pos = np.asarray(label) == 1
    return float((ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2)
                 / (pos.sum() * (~pos).sum()))


def obs_phase(lt, hw, hc, params, ds, main_trees, legacy, kind, card):
    """(28) The main path (5 rounds) with every observability plane off,
    then with each of ``tpu_telemetry``, ``tpu_health=strict``,
    ``tpu_profile`` and ``tpu_trace`` on alone, then all four, then off
    again; counts zeroed before each run and read after.  Every run's
    trees must be the main path's (``trees_digest``), and the model text
    of a run with the planes off the main path's under the earlier
    parameter-block rule (``legacy_digest``, the digest earlier runs
    recorded); the all-on run's telemetry file must hold 5
    ``iteration`` events, ``kernel_profile`` events of K1 against
    ``hist_wave_cost``'s bound, and a memory peak at or under the run's
    ``max_memory_allocated`` (profile mode resets the allocator's peak at
    each phase exit, so the run's is the largest read before a reset); ``torch.cuda.synchronize`` is counted in the
    first and the last (planes off) runs, and the last may make no more
    than the first.  Then the same with ``feature_fraction_bynode`` (the
    serial grower, K2) under ``tpu_health=strict``, 2 rounds.  Returns
    (K1 counts of the all-on run, K2 counts of the serial run, s/iter by
    plane, seconds)."""
    import shutil

    import torch
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import profile
    t0 = time.perf_counter()
    tel = os.path.join(SCRATCH, "telemetry")
    shutil.rmtree(tel, ignore_errors=True)
    syncs = [0]
    real_sync = torch.cuda.synchronize
    real_reset = torch.cuda.reset_peak_memory_stats
    run_peak = [0]

    def counted(*a, **k):
        syncs[0] += 1
        return real_sync(*a, **k)

    def peak_kept(*a, **k):
        # profile mode resets the allocator's peak at each phase exit;
        # the run's own peak is the largest one read before a reset
        run_peak[0] = max(run_peak[0], torch.cuda.max_memory_allocated())
        return real_reset(*a, **k)

    def off():
        obs.disable()
        obs.enable_profile(False)
        obs.enable_health("")
        obs.enable_trace(False)
        obs.reset()

    planes = {"off": {}, "telemetry": {"tpu_telemetry": tel + "_t"},
              "health": {"tpu_health": "strict"},
              "profile": {"tpu_profile": True}, "trace": {"tpu_trace": True},
              "all": {"tpu_telemetry": tel, "tpu_health": "strict",
                      "tpu_profile": True, "tpu_trace": True},
              "off again": {}}
    s_iter, sync_n, all_counts, peak = {}, {}, None, None
    torch.cuda.synchronize = counted
    torch.cuda.reset_peak_memory_stats = peak_kept
    try:
        for name, extra in planes.items():
            off()
            syncs[0] = 0
            reset_counts(hw, hc)
            real_reset()
            run_peak[0] = 0
            bst = lt.train({**params, **extra}, ds, num_boost_round=5,
                           device=DEV)
            counts = read_counts(hw, hc)
            sync_n[name] = syncs[0]
            s_iter[name] = float(np.median(bst._gbdt.iter_seconds[1:]))
            if trees_digest(bst) != main_trees or (
                    not extra and legacy_digest(bst) != legacy):
                raise AssertionError(f"obs {name}: trees differ from the "
                                     f"main path's ({trees_digest(bst)}, "
                                     f"{legacy_digest(bst)})")
            if name == "all":
                all_counts = counts
                peak = max(run_peak[0], torch.cuda.max_memory_allocated())
                obs.event("summary", **obs.digest())
            del bst
        off()
    finally:
        torch.cuda.synchronize = real_sync
        torch.cuda.reset_peak_memory_stats = real_reset
    events = [json.loads(line) for line in
              open(os.path.join(tel, "telemetry.0.jsonl"))]
    iters = [e for e in events if e["event"] == "iteration"]
    kp = [e for e in events if e["event"] == "kernel_profile"
          and e["kernel"] == "hist_wave"]
    k1_bound_ok = all(
        abs(e["roofline_s"] - profile.roofline_seconds(
            e["flops"], e["bytes"])) <= 1e-9 for e in kp)
    summ = [e for e in events if e["event"] == "summary"][-1]
    mem_peak = summ.get("memory", {}).get("peak_bytes", 0)
    spans = sum(1 for e in events if e["event"] == "span")
    fps = sum(1 for e in events if e["event"] == "fingerprint")
    k1 = summ.get("kernels", {}).get("hist_wave", {})
    print(f"obs: s/iter by plane {json.dumps(s_iter)}; "
          f"torch.cuda.synchronize calls by run {json.dumps(sync_n)}; "
          f"all planes on: {len(iters)} iteration events, {len(kp)} K1 "
          f"kernel_profile events for {all_counts['k1']} K1 launches "
          f"(bound = hist_wave_cost: {k1_bound_ok}; K1 {k1.get('achieved_s')}"
          f" s against a bound of {k1.get('roofline_s')} s), {fps} "
          f"fingerprints, {spans} spans, memory peak {mem_peak} bytes "
          f"(max_memory_allocated {peak}) [{kind}, {card}]", flush=True)
    if len(iters) != 5 or not kp or not k1_bound_ok \
            or len(kp) != all_counts["k1"]:
        raise AssertionError("the telemetry file lacks the iterations or "
                             "K1's profile")
    if not 0 < mem_peak <= peak:
        raise AssertionError(f"memory peak {mem_peak} is not within "
                             f"max_memory_allocated {peak}")
    if sync_n["off again"] > sync_n["off"]:
        raise AssertionError("with every plane off the main path "
                             "synchronizes more than the plain run")
    # the serial grower (K2) under the health sentinels
    off()
    reset_counts(hw, hc)
    sp = {**params, "feature_fraction_bynode": 0.5, "tpu_health": "strict"}
    sbst = lt.train(sp, ds, num_boost_round=2, device=DEV)
    serial_counts = read_counts(hw, hc)
    checks = obs.counter_value("health/checks")
    off()
    print(f"obs: serial grower (K2) under tpu_health=strict: "
          f"{serial_counts['k2']} K2 launches, "
          f"{len(sbst._gbdt.models)} trees, s/iter "
          f"{float(np.mean(sbst._gbdt.iter_seconds)):.4f} [{kind}, {card}]",
          flush=True)
    if sbst._gbdt.uses_wave or serial_counts["k2"] == 0:
        raise AssertionError("the serial grower did not run K2 under "
                             "health")
    del sbst, checks
    return all_counts, serial_counts, s_iter, time.perf_counter() - t0


def drift_phase(lt, model, X, kind, card):
    """(28, serving) The phase-22 model (saved with its quality sidecar)
    served with ``tpu_drift`` on, every row sampled: ``DRIFT_ROWS`` of its
    training rows breach nothing, as many other rows shifted (x 2.5 + 1.5)
    breach; over HTTP
    ``/drift`` answers the monitor's status and ``/debug/flight`` the
    flight ring (200)."""
    from lightgbm_tpu_torch.serve import PredictorSession, PredictServer
    cfg = {"tpu_drift_sample_rate": 1.0, "tpu_drift_min_rows": 1000,
           "verbose": -1}
    sess = PredictorSession(model, config=cfg, device=DEV)
    server = None
    try:
        mon = sess._drift
        if mon is None:
            raise AssertionError("the served model's sidecar armed no "
                                 "drift monitor")
        n = DRIFT_ROWS
        for lo in range(0, n, 1024):
            sess.predict(X[lo:min(lo + 1024, n)])
        quiet = mon.maybe_check(force=True)
        quiet_breach = mon.breach
        mon.reset_window()
        shifted = X[n:2 * n] * 2.5 + 1.5
        for lo in range(0, len(shifted), 1024):
            sess.predict(shifted[lo:lo + 1024])
        loud = mon.maybe_check(force=True)
        server = PredictServer(sess).start()
        _, drift, _ = http(server.url + "/drift")
        flight_code, flight, _ = http(server.url + "/debug/flight")
    finally:
        if server is not None:
            server.stop()
        sess.close()
    print(f"drift: in-distribution psi_max {quiet['psi_max']} pred_psi "
          f"{quiet['pred_psi']} (breach {quiet_breach}); shifted psi_max "
          f"{loud['psi_max']} pred_psi {loud['pred_psi']} (breach "
          f"{mon.breach and mon.breach['kinds']}); /drift armed "
          f"{drift.get('armed')}, /debug/flight {flight_code} with "
          f"{len(flight.get('events', []))} events [{kind}, {card}]",
          flush=True)
    if quiet_breach is not None or mon.breach is None:
        raise AssertionError("drift: no breach on shifted rows, or one on "
                             "in-distribution rows")
    if not drift.get("drift") or flight_code != 200:
        raise AssertionError("/drift or /debug/flight did not answer")


# ---- 29: refit and the online loop (the twelfth slice) --------------------
REFIT_ROWS = 1_000_000           # fresh rows of Booster.refit (a new seed)
REFIT_CHECK_ROWS = 100_000       # of them, predicted by both refits
REFIT_CLI_ROWS = 200_000         # the CLI phase's rows, labels flipped
ONLINE_ROWS = 60_000             # lines of the label stream
ONLINE_FAULT_ROWS = 40_000       # its first lines: the faulted run's stream
ONLINE_WINDOW = 50_000
ONLINE_EVERY = 20_000
ONLINE_POOL = 20_000             # rows the online run's requests are cut from
CONTINUE_ROWS = 50_000
CONTINUE_TREES = 10


def leaf_error(a, b) -> float:
    """The largest |leaf value| difference of two boosters over one
    forest's structure (checked equal tree by tree)."""
    worst = 0.0
    for ta, tb in zip(a._gbdt.models, b._gbdt.models):
        nn = ta.num_leaves - 1
        if (ta.num_leaves != tb.num_leaves
                or not np.array_equal(ta.split_feature[:nn],
                                      tb.split_feature[:nn])
                or not np.array_equal(ta.threshold[:nn], tb.threshold[:nn])):
            raise AssertionError("a refit changed a tree's structure")
        worst = max(worst, float(np.abs(ta.leaf_value - tb.leaf_value).max()))
    return worst


def refit_bounds(forest_bytes: int, T: int, N: int, F: int) -> dict:
    """Byte bounds of the forest walks and the refit steps over ``T``
    trees, ``N`` rows and ``F`` features, each input read once and each
    output written once.  The refit's leaf walk reads the stacked forest
    (``forest_bytes``) and the u8 bins [N, F] and writes the int64 leaf
    ids [T, N]; the steps, per tree, read its leaf ids (8 B a row), read
    and write the f32 score, and read the label and write g and h in the
    gradient step and read them in the sums (4 B each).  The serving walk
    (``forest_predict_fn``) reads the forest and the int32 bins of the
    served rows and writes one f32 score a row: at 1 row, 1,024 rows (the
    largest bucket) and N rows."""
    out = {"leaf_walk": bound(forest_bytes + N * F + 8 * T * N, T * N),
           "steps": bound(T * N * (8 + 4 + 4 + 4 + 8 + 8), 10 * T * N)}
    for n in (1, 1024, N):
        out[f"serving_walk_{n}"] = bound(forest_bytes + n * (4 * F + 4),
                                         T * n)
    return out


def refit_phase(lt, model, kind, card):
    """(29a) ``Booster.refit`` of the served model (100 trees x 255 leaves)
    on 1,000,000 fresh HIGGS-shaped rows at decay 0.9: the device path
    twice, then the host oracle (``tpu_refit_device=false``); every leaf
    within 1e-6 of the oracle, 100,000 rows' predictions within 1e-6, the
    two device refits' model texts byte-equal; wall s by path (the new
    rows' binning and the trainer's set-up included), the leaf walk's and
    the steps' ms by CUDA events against their byte bounds, and the
    ``refit`` events.  Returns the numbers."""
    from lightgbm_tpu_torch import obs
    Xn, yn = higgs_like(REFIT_ROWS, seed=29)
    bst = lt.Booster(model_file=model)
    sink = os.path.join(SCRATCH, "telemetry_refit.jsonl")
    if os.path.exists(sink):
        os.remove(sink)
    obs.enable(sink)
    walls, runs = {}, {}
    try:
        for name, kw in (("device", {}), ("device again", {}),
                         ("host", {"tpu_refit_device": False})):
            t0 = time.perf_counter()
            runs[name] = bst.refit(Xn, yn, decay_rate=0.9, **kw)
            walls[name] = round(time.perf_counter() - t0, 3)
    finally:
        obs.disable()
    with open(sink) as fh:
        events = [e for e in map(json.loads, fh) if e.get("event") == "refit"]
    dev, host = runs["device"], runs["host"]
    leaf_err = leaf_error(dev, host)
    moved = leaf_error(dev, bst)
    rows = Xn[:REFIT_CHECK_ROWS]
    pred_err = float(np.abs(dev.predict(rows) - host.predict(rows)).max())
    same_text = dev.model_to_string() == runs["device again"].model_to_string()
    rep, again = (runs[k]._gbdt.last_refit for k in ("device",
                                                       "device again"))
    from lightgbm_tpu_torch.core.forest import stack_forest
    gb = dev._gbdt
    T = len(gb.models)
    forest = stack_forest([gb._tree_arrays_np(t) for t in gb.models],
                          np.zeros(T, np.int32), "cpu")
    forest_bytes = sum(v.numel() * v.element_size() for v in forest
                       if hasattr(v, "element_size"))
    b = refit_bounds(forest_bytes, T, REFIT_ROWS, 28)
    serving = {n: b[f"serving_walk_{n}"]["bound_ms"]
               for n in (1, 1024, REFIT_ROWS)}
    out = {"trees": T, "rows": REFIT_ROWS, "wall_s": walls,
           "leaf_walk_ms": [rep["leaf_walk_ms"], again["leaf_walk_ms"]],
           "steps_ms": [rep["steps_ms"], again["steps_ms"]],
           "leaf_walk_bound_ms": b["leaf_walk"]["bound_ms"],
           "steps_bound_ms": b["steps"]["bound_ms"],
           "serving_walk_bound_ms": serving, "forest_bytes": forest_bytes,
           "max_leaf_err": leaf_err, "max_pred_err": pred_err,
           "byte_equal": same_text}
    print(f"refit (Booster.refit, {T} trees x "
          f"{max(t.num_leaves for t in gb.models)} leaves on {REFIT_ROWS:,} "
          f"fresh rows, decay 0.9): wall s {walls} (binning and set-up "
          f"included); leaf walk {rep['leaf_walk_ms']:.3f} / "
          f"{again['leaf_walk_ms']:.3f} ms (bound "
          f"{b['leaf_walk']['bound_ms']:.4f} ms by bytes), steps "
          f"{rep['steps_ms']:.3f} / {again['steps_ms']:.3f} ms (bound "
          f"{b['steps']['bound_ms']:.4f} ms by bytes) by CUDA events; max "
          f"|leaf - host oracle| {leaf_err:.3g} (tol 1e-6), max |pred - "
          f"oracle's| on {REFIT_CHECK_ROWS:,} rows {pred_err:.3g} (tol "
          f"1e-6), leaves moved by up to {moved:.3g}; two device refits' "
          f"texts byte-equal: {same_text}; the serving walk's byte bound "
          f"at 1 / 1,024 / {REFIT_ROWS:,} rows {serving} ms (stacked "
          f"forest {forest_bytes:,} bytes); refit events "
          f"{json.dumps(events)} [{kind}, {card}]", flush=True)
    if (leaf_err > 1e-6 or pred_err > 1e-6 or not same_text or moved < 1e-6
            or [e["mode"] for e in events] != ["device", "device", "host"]):
        raise AssertionError("the device refit disagrees with its oracle "
                             "or with itself")
    return out


def cli_refit_phase(lt, cli_model, kind, card):
    """(29b) ``python -m lightgbm_tpu_torch task=refit`` of the CLI phase's
    model (5 trees x 255 leaves) on its 200,000 rows with flipped labels,
    a subprocess on the card: exit 0, every tree's structure kept, the
    leaves moved, and the output within 1e-10 of ``Booster.refit`` on the
    same rows (the file's rows as ``load_text`` reads them).  Returns the
    wall s."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.text_loader import load_text
    X, y = higgs_like(REFIT_CLI_ROWS, seed=2)
    d = os.path.join(SCRATCH, "refit_cli")
    os.makedirs(d, exist_ok=True)
    data = os.path.join(d, "flipped.tsv")
    out = os.path.join(d, "refit.txt")
    np.savetxt(data, np.column_stack([1.0 - y, X]), delimiter="\t",
               fmt="%.9g")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=refit",
         f"data={data}", f"input_model={cli_model}", f"output_model={out}",
         "verbosity=-1"], capture_output=True, text=True, timeout=600,
        env=env)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"task=refit exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    Xf, yf = load_text(data, Config())[:2]
    orig = lt.Booster(model_file=cli_model)
    cli = lt.Booster(model_file=out)
    inproc = orig.refit(Xf, yf, decay_rate=0.9)
    moved = leaf_error(orig, cli)
    leaf_err = leaf_error(cli, inproc)
    err = float(np.abs(cli.predict(Xf) - inproc.predict(Xf)).max())
    print(f"CLI task=refit ({REFIT_CLI_ROWS:,} x 28 TSV, flipped labels, "
          f"{len(cli._gbdt.models)} trees): {wall:.1f} s wall; structure "
          f"kept, leaves moved by up to {moved:.3g}; max |output - "
          f"Booster.refit| {err:.3g} (tol 1e-10), leaves {leaf_err:.3g} "
          f"[{kind}, {card}]", flush=True)
    if moved < 1e-3 or err > 1e-10:
        raise AssertionError("task=refit disagrees with Booster.refit")
    return round(wall, 1)


def label_stream(path, X, y):
    """A JSONL label stream, one ``{"x": [...], "y": label}`` line a row."""
    with open(path, "w") as fh:
        for xr, yr in zip(X.tolist(), y.tolist()):
            fh.write(json.dumps({"x": xr, "y": yr}) + "\n")


def online_phase(lt, model, kind, card):
    """(29c) ``run_online`` in process over HTTP: a registry of 2 replicas
    on the card serving the phase-22 model (its quality sidecar arms the
    windows), ``PredictServer`` on a free port, a 60,000-line label stream
    of fresh rows, window 50,000, a refit every 20,000 rows: 3 versions
    pushed through ``POST /models/default/swap`` (the drain included), 0
    rejected, 0 failed; a client thread's replies all 200, each within
    1e-6 of ``Booster.predict`` of the version it names; the
    ``tpu_online_*`` series of ``/metrics`` equal to ``stats()``; an
    ``OnlineLoop(push=None)`` replay of the stream writes byte-equal
    version files.  Then a 40,000-line run with one ``online_refit:raise``
    fault: 1 failed, and the next cycle pushes a refit of the unchanged
    base (byte-equal to ``refit_from_model`` of the served model over its
    window).  Returns the numbers."""
    import shutil
    import threading
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.online import (OnlineLoop, read_label_stream,
                                           refit_from_model, run_online)
    from lightgbm_tpu_torch.robust import faults
    from lightgbm_tpu_torch.serve import parse_prometheus
    d = os.path.join(SCRATCH, "online")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    Xs, ys = higgs_like(ONLINE_ROWS, seed=31)
    Xs = np.round(Xs, 5)
    stream = os.path.join(d, "labels.jsonl")
    fault_stream = os.path.join(d, "labels_fault.jsonl")
    label_stream(stream, Xs, ys)
    label_stream(fault_stream, Xs[:ONLINE_FAULT_ROWS], ys[:ONLINE_FAULT_ROWS])
    pool = np.round(higgs_like(ONLINE_POOL, seed=33)[0], 5)
    params = {"verbose": -1}

    def config(source, out_dir, port):
        return Config.from_params({
            "task": "online", "input_model": model,
            "tpu_online_source": source, "tpu_online_window": ONLINE_WINDOW,
            "tpu_online_refit_every": ONLINE_EVERY,
            "tpu_online_mode": "refit", "tpu_online_dir": out_dir,
            "tpu_serve_replicas": 2, "tpu_serve_port": port,
            "tpu_serve_rollback_watch_s": 0, "verbose": -1})

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    replies, status, errors = [], {}, []
    stop = threading.Event()

    def request(rng):
        n = int(rng.integers(1, 257))
        lo = int(rng.integers(0, len(pool) - n))
        code, body, _ = http(url + "/predict",
                             {"rows": pool[lo:lo + n].tolist()})
        status[code] = status.get(code, 0) + 1
        if code == 200:
            replies.append((body["version"], lo, n,
                            np.asarray(body["predictions"])))

    def client():
        rng = np.random.default_rng(7)
        deadline = time.time() + 300
        while not stop.is_set() and time.time() < deadline:
            try:
                if http(url + "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                time.sleep(0.1)
        while not stop.is_set():
            try:
                request(rng)
            except Exception as exc:  # noqa: BLE001 — a lost request
                errors.append(f"{type(exc).__name__}: {exc}")

    seen = {}

    def on_drained(loop, reg, server):
        stop.set()
        thread.join(120)
        rng = np.random.default_rng(8)
        for _ in range(8):          # replies from the last version
            request(rng)
        _, text, _ = http(server.url + "/metrics")
        seen["metrics"] = parse_prometheus(text)
        seen["stats"] = loop.stats()
        seen["sources"] = {v["version"]: v["source"]
                           for v in reg.models()[0]["versions"]}
        seen["quality_armed"] = loop.quality is not None

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    st = run_online(config(stream, os.path.join(d, "run"), port), params,
                    on_drained=on_drained)
    run_s = time.perf_counter() - t0
    stop.set()
    thread.join(120)
    by_version, bad = {}, []
    refs = {}
    for v, lo, n, got in replies:
        if v not in refs:
            refs[v] = lt.Booster(model_file=seen["sources"][v]).predict(pool)
        by_version[v] = by_version.get(v, 0) + 1
        err = float(np.abs(got - refs[v][lo:lo + n]).max())
        if err > 1e-6:
            bad.append((v, lo, n, err))
    m, sst = seen["metrics"], seen["stats"]
    series = {k: m.get(f'tpu_online_refresh_total{{outcome="{o}"}}')
              for k, o in (("versions", "pushed"), ("rejected", "rejected"),
                           ("failed", "failed"), ("skipped", "skipped"))}
    series["rows_ingested"] = m.get("tpu_online_rows_ingested_total")
    metrics_ok = (all(series[k] == sst[k] for k in series)
                  and m.get("tpu_online_swap_rejected_total") == sst["rejected"]
                  and 0 <= m.get("tpu_online_last_refresh_age_seconds", -1)
                  <= sst["last_refresh_age_s"] + 5)
    quality = sst.get("quality") or {}
    # the replay: the same stream through a loop that pushes nowhere
    t1 = time.perf_counter()
    replay = OnlineLoop(model, config=config(stream, "", 0), push=None,
                        workdir=os.path.join(d, "replay"), params=params)
    for batch in read_label_stream(stream):
        replay.ingest(*batch)
        replay.tick()
    if replay._rows_since > 0:
        replay.refresh()
    replay_s = time.perf_counter() - t1
    names = [f"model_v{i}.txt" for i in (2, 3, 4)]

    def text(*parts):
        with open(os.path.join(d, *parts)) as fh:
            return fh.read()
    replay_equal = all(text("run", n) == text("replay", n) for n in names)
    # one injected refit fault: failed, the base kept, the next cycle pushes
    faults.configure("online_refit:raise")
    try:
        t2 = time.perf_counter()
        fst = run_online(config(fault_stream, os.path.join(d, "fault"),
                                free_port()), params)
        fault_s = time.perf_counter() - t2
    finally:
        faults.disarm()
    rows = [b for b in read_label_stream(fault_stream)]
    Xf = np.concatenate([b[0] for b in rows])
    yf = np.concatenate([b[1] for b in rows])
    want = refit_from_model(model, Xf[-ONLINE_WINDOW:], yf[-ONLINE_WINDOW:],
                            params=params, decay_rate=0.9).model_to_string()
    base_kept = text("fault", "model_v3.txt") == want
    out = {"versions": st["versions"], "rejected": st["rejected"],
           "failed": st["failed"], "replies": by_version,
           "status": status, "lost": len(errors), "mismatches": len(bad),
           "run_s": round(run_s, 1), "replay_s": round(replay_s, 1),
           "fault_run_s": round(fault_s, 1)}
    print(f"online (run_online over HTTP, 2 replicas on {DEV}, "
          f"{ONLINE_ROWS:,}-line stream, window {ONLINE_WINDOW:,}, refit "
          f"every {ONLINE_EVERY:,}): {run_s:.1f} s; pushed {st['versions']}, "
          f"rejected {st['rejected']}, failed {st['failed']}, skipped "
          f"{st['skipped']}, rows {st['rows_ingested']:,}; replies by "
          f"version {by_version}, status {status}, lost {len(errors)}, "
          f"mismatches {len(bad)} (tol 1e-6); /metrics tpu_online_* "
          f"{series} equal to stats(): {metrics_ok}; quality windows armed "
          f"{seen['quality_armed']} ({quality.get('windows')} windows, last "
          f"AUC {(quality.get('last') or {}).get('auc')}); replay "
          f"{replay_s:.1f} s, version files byte-equal: {replay_equal}; "
          f"faulted run ({ONLINE_FAULT_ROWS:,} lines, online_refit:raise) "
          f"{fault_s:.1f} s: failed {fst['failed']}, pushed "
          f"{fst['versions']}, the pushed refit of the unchanged base "
          f"byte-equal: {base_kept} [{kind}, {card}]", flush=True)
    if (st["versions"] != 3 or st["rejected"] or st["failed"] or errors
            or bad or set(status) != {200} or not metrics_ok
            or not seen["quality_armed"] or not quality.get("windows")
            or not replay_equal or max(by_version, default=0) != 4
            or fst["failed"] != 1 or fst["versions"] != 1 or not base_kept):
        raise AssertionError(f"the online loop misbehaved: {out} "
                             f"{errors[:3]} {bad[:3]}")
    return out


def continue_phase(lt, hw, hc, model, kind, card):
    """(29d) ``tpu_online_mode=continue``: one refresh of 10 new trees over
    a 50,000-row window in the served model's own bin space, K1 counts
    zeroed first; the model has 110 trees, every new threshold is one of
    the base model's, and the window's logloss falls below the base
    model's.  Returns (K1 launches, seconds)."""
    from lightgbm_tpu_torch.online import OnlineLoop
    Xw, yw = higgs_like(CONTINUE_ROWS, seed=35)
    cfg = {"tpu_online_mode": "continue", "tpu_online_trees": CONTINUE_TREES,
           "tpu_online_window": CONTINUE_ROWS,
           "tpu_online_refit_every": CONTINUE_ROWS}
    loop = OnlineLoop(model, config=cfg, push=None,
                      workdir=os.path.join(SCRATCH, "online_continue"),
                      params={"verbose": -1})
    loop.ingest(Xw, yw)
    reset_counts(hw, hc)
    t0 = time.perf_counter()
    rep = loop.tick()
    secs = time.perf_counter() - t0
    counts = read_counts(hw, hc)
    base = lt.Booster(model_file=model)
    cont = lt.Booster(model_file=loop.base)
    thr = {float(t) for tr in base._gbdt.models
           for t in tr.threshold[:max(tr.num_leaves - 1, 0)]}
    new_ok = all(float(tr.threshold[i]) in thr
                 for tr in cont._gbdt.models[len(base._gbdt.models):]
                 for i in range(max(tr.num_leaves - 1, 0)))

    def logloss(p):
        p = np.clip(p, 1e-12, 1 - 1e-12)
        return float(-np.mean(yw * np.log(p) + (1 - yw) * np.log(1 - p)))
    before, after = logloss(base.predict(Xw)), logloss(cont.predict(Xw))
    print(f"online continue ({CONTINUE_TREES} trees on a {CONTINUE_ROWS:,}-"
          f"row window in the model's bin space): {secs:.2f} s, "
          f"{cont.num_trees()} trees, new thresholds all the base model's: "
          f"{new_ok}, window logloss {before:.6f} -> {after:.6f}; K1 "
          f"launches {counts['k1']} ({counts}) [{kind}, {card}]", flush=True)
    if (not rep or not rep["ok"] or not new_ok
            or cont.num_trees() != base.num_trees() + CONTINUE_TREES
            or not after < before or counts["k1"] == 0):
        raise AssertionError("continue mode did not grow the model")
    return counts["k1"], secs


AOT_CALLS = 100                  # graph-replay calls per bucket (p50/p99)
AOT_EAGER_CALLS = 30             # eager-walk calls per bucket, beside them
AOT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
AOT_REQ1_ROWS = 16               # request #1's rows


def aot_child(argv) -> int:
    """(30, child) One cold serving process: ``PredictorSession(model)``
    with the store at ``argv[1]`` on the card; its pack (from the store or
    the model), the warm-up that captures one CUDA graph per bucket,
    request #1 against the steady p99 at its bucket, graph replay against
    the session's eager walk at every bucket (bit-equal answers; sync p50
    and p99 of each), and the captures made on the request path.  Writes
    one JSON object to ``argv[2]``."""
    import torch
    t_start = time.perf_counter()
    sys.path.insert(0, HERE)
    from lightgbm_tpu_torch.serve import PredictorSession
    from lightgbm_tpu_torch.serve import aot as paot
    model, store, out_path = argv
    X, _ = higgs_like(2048, seed=30)
    t0 = time.perf_counter()
    sess = PredictorSession(model, config={"tpu_serve_aot_dir": store},
                            device=DEV)
    pack_s = time.perf_counter() - t0
    res = {"import_s": round(t0 - t_start, 3), "pack_s": round(pack_s, 4),
           "aot": sess.stats()["aot"]}
    try:
        t0 = time.perf_counter()
        n = sess.warmup()
        res["warmup_s"] = round(time.perf_counter() - t0, 3)
        res["buckets_warmed"] = n
        captures0 = sess.stats()["graph_captures"]
        res["captures_at_warmup"] = captures0
        t0 = time.perf_counter()
        first = sess.predict(X[:AOT_REQ1_ROWS])
        res["request1_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        lat, equal = {}, {}
        for b in AOT_BUCKETS:
            rows = X[:b]
            graph_ms, eager_ms = [], []
            for _ in range(AOT_CALLS):
                t0 = time.perf_counter()
                got = sess.predict(rows, raw_score=True)
                graph_ms.append((time.perf_counter() - t0) * 1e3)
            # the same session's eager walk (no graph), measured only
            graphs, sess._graphs = sess._graphs, None
            try:
                for _ in range(AOT_EAGER_CALLS):
                    t0 = time.perf_counter()
                    eager = sess.predict(rows, raw_score=True)
                    eager_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                sess._graphs = graphs
            equal[b] = bool(np.array_equal(got, eager))
            lat[b] = {"graph_p50_ms": round(pct(graph_ms, 0.5), 4),
                      "graph_p99_ms": round(pct(graph_ms, 0.99), 4),
                      "eager_p50_ms": round(pct(eager_ms, 0.5), 4),
                      "eager_p99_ms": round(pct(eager_ms, 0.99), 4)}
        res["buckets"] = lat
        res["graph_equals_eager"] = equal
        res["steady_p99_ms_at_request1_bucket"] = \
            lat[AOT_REQ1_ROWS]["graph_p99_ms"]
        res["first_equals_steady"] = bool(np.array_equal(
            first, sess.predict(X[:AOT_REQ1_ROWS])))
        res["request_path_captures"] = \
            sess.stats()["graph_captures"] - captures0
        res["replays"] = dict(paot.graph_replays)
        res["raw_1024"] = sess.predict(X[:1024], raw_score=True).tolist()
        res["aot_after"] = sess.stats()["aot"]
    finally:
        sess.close()
    with open(out_path, "w") as fh:
        json.dump(res, fh)
    return 0


def aot_phase(lt, model, kind, card):
    """(30) Cold restarts of a served model: phase 22's model (100 trees x
    255 leaves) served by two cold subprocesses of this script on one
    store directory, the first on an empty store (miss: it packs from the
    model and writes the entry), the second on the warm store (hit); each
    captures one CUDA graph per bucket at warm-up, and must answer every
    bucket bit-equal to its eager walk, capture nothing on the request
    path, and give the same scores as the other.  Then a corrupt entry in
    this process: one ``aot_fallback``, the same scores.  Returns the
    phase's record."""
    import shutil

    from lightgbm_tpu_torch.serve import PredictorSession
    t_phase = time.perf_counter()
    store = os.path.join(SCRATCH, "aot_store")
    shutil.rmtree(store, ignore_errors=True)
    runs = {}
    for name in ("cold_empty_store", "cold_warm_store"):
        out = os.path.join(SCRATCH, f"aot_{name}.json")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--aot-child", model, store, out],
                           capture_output=True, text=True, timeout=600,
                           cwd=HERE)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"aot child {name} failed:\n{r.stdout}\n"
                                 f"{r.stderr[-4000:]}")
        with open(out) as fh:
            runs[name] = json.load(fh)
        runs[name]["process_s"] = round(wall, 2)
    a, b = runs["cold_empty_store"], runs["cold_warm_store"]
    for name, r in runs.items():
        lat = r["buckets"]
        print(f"AOT {name}: store {r['aot']['status']} (loaded "
              f"{r['aot']['loaded']}, saved {r['aot']['saved']}), session "
              f"built (model text loaded, forest packed or read) in "
              f"{r['pack_s'] * 1e3:.1f} ms, warm-up {r['warmup_s']:.2f} s "
              f"({r['captures_at_warmup']} CUDA graphs for "
              f"{r['buckets_warmed']} buckets); request #1 "
              f"{r['request1_ms']:.3f} ms vs steady p99 "
              f"{r['steady_p99_ms_at_request1_bucket']:.3f} ms at bucket "
              f"{AOT_REQ1_ROWS}; captures on the request path "
              f"{r['request_path_captures']}; graph == eager at every "
              f"bucket {all(r['graph_equals_eager'].values())}; process "
              f"{r['process_s']} s [{kind}, {card}]", flush=True)
        print(f"AOT {name} sync ms by bucket (graph p50/p99 | eager "
              f"p50/p99): " + ", ".join(
                  f"{k}: {v['graph_p50_ms']:.3f}/{v['graph_p99_ms']:.3f} | "
                  f"{v['eager_p50_ms']:.3f}/{v['eager_p99_ms']:.3f}"
                  for k, v in lat.items()) + f" [{kind}, {card}]",
              flush=True)
        if (r["request_path_captures"] != 0
                or not all(r["graph_equals_eager"].values())
                or r["captures_at_warmup"] != len(AOT_BUCKETS)
                or not r["first_equals_steady"]):
            raise AssertionError(f"AOT {name}: graphs and eager disagree "
                                 "or the request path captured")
    if (a["aot"]["status"] != "miss" or a["aot"]["saved"] != 1
            or b["aot"]["status"] != "hit" or b["aot"]["loaded"] != 1
            or a["raw_1024"] != b["raw_1024"]):
        raise AssertionError("AOT: the store's miss/hit round trip failed "
                             "or the two processes' scores differ")
    # a corrupt entry: packed from the model, loudly, the same scores
    for f in os.listdir(store):
        p = os.path.join(store, f)
        with open(p, "r+b") as fh:
            fh.truncate(os.path.getsize(p) // 3)
    X, _ = higgs_like(2048, seed=30)
    with PredictorSession(model, config={"tpu_serve_aot_dir": store},
                          device=DEV) as sess:
        st = sess.stats()["aot"]
        raw = sess.predict(X[:1024], raw_score=True)
    same = raw.tolist() == a["raw_1024"]
    print(f"AOT corrupt entry: status {st['status']}, fallbacks "
          f"{st['fallbacks']}, rewritten {st['saved']}; scores equal to "
          f"the cold processes' {same} [{kind}, {card}]", flush=True)
    if st["status"] != "fallback" or st["fallbacks"] != 1 or not same:
        raise AssertionError("AOT: a corrupt entry did not fall back")
    shutil.rmtree(store, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    print(f"phase 30: {secs:.1f} s [{kind}, {card}]", flush=True)
    return {"cold_empty_store": {k: v for k, v in a.items()
                                 if k != "raw_1024"},
            "cold_warm_store": {k: v for k, v in b.items()
                                if k != "raw_1024"},
            "phase_30_s": round(secs, 1)}


PARALLEL_ROUNDS = 5
# the voting and feature legs (3.4-3.7 and 1.9-2.1 s an iteration on one
# card) run 3 rounds: the script's time limit, since phases 32-33
PARALLEL_ROUNDS_SERIAL_GROWER = 3


def parallel_phase(lt, hw, hc, params, ds, X, y, int16_parts, main_parts,
                   res, kind, card):
    """(31) Multi-GPU training's path on the card's one GPU: two ranks
    (``lightgbm_tpu_torch/tools/dist_check.py``, one process each, both on
    ``cuda:0``, so the collectives take gloo with an explicit host copy)
    on the headline 1,000,000 x 28 rows with phase 4's parameters, 5
    rounds for ``tree_learner=data`` in 2xbf16 and int16 (K1, unfused),
    3 for ``voting`` and ``feature`` (K2 at C=32).  Both ranks must write the
    same model; the int16 trees must be phase 5's (legacy digest
    614716ef924a0d6e under phase 5's parameter block); 2xbf16's equality
    with phase 4's is reported.  Then world size 1 through the same code
    in this process (``tree_learner=data``, int16 and 2xbf16), and K1 and
    K2 against their plain versions at the parallel paths' shapes: K1 on
    one rank's 500,000 rows unfused, its exact int16 sums, K2 on one
    rank's 14-column block.  Returns (record, launches by mode)."""
    import torch
    from lightgbm_tpu_torch.tools.dist_check import launch
    t_phase = time.perf_counter()
    d = os.path.join(SCRATCH, "parallel")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "rows.npz"), X=X, y=y)
    # the 2xbf16 data leg runs telemetry, so the ranks exchange their
    # phase walls (obs/ranks.py): its skew table is printed.  No metric:
    # the iteration record would evaluate the training metrics on 1M rows
    # each round (0.28-0.40 s/iter became 0.61, NVIDIA H100 80GB HBM3,
    # 700 W), and the trees do not depend on them
    modes = {"data_2xbf16": dict(params, tree_learner="data", metric="none",
                                 tpu_telemetry=os.path.join(d, "telemetry")),
             "data_int16": dict(params, tree_learner="data",
                                tpu_hist_dtype="int16"),
             "voting": dict(params, tree_learner="voting"),
             "feature": dict(params, tree_learner="feature")}
    spec = {"data": os.path.join(d, "rows.npz"), "device": DEV,
            "modes": [{"name": n, "params": p,
                       "rounds": (PARALLEL_ROUNDS if n.startswith("data")
                                  else PARALLEL_ROUNDS_SERIAL_GROWER)}
                      for n, p in modes.items()]}
    with open(os.path.join(d, "spec.json"), "w") as fh:
        json.dump(spec, fh)
    t0 = time.perf_counter()
    ranks = launch(os.path.join(d, "spec.json"), 2, d, timeout=900,
                   rank_env={r: {"LGBM_TPU_RANK": str(r)} for r in (0, 1)})
    two_s = time.perf_counter() - t0
    rec = {"two_ranks_s": round(two_s, 1), "modes": {}}
    launches = {}
    for name in modes:
        r0, r1 = (r["modes"][name] for r in ranks)
        head = [r["modes"][name]["model"].split("\nparameters:")[0]
                for r in ranks]
        dig = [hashlib.sha256(h.encode()).hexdigest()[:16] for h in head]
        row = {"s_per_iter": [round(float(np.median(r["iter_s"][1:])), 4)
                              for r in (r0, r1)],
               "first_iter_s": [round(r["iter_s"][0], 4) for r in (r0, r1)],
               "collectives": [r["collectives"] for r in (r0, r1)],
               "k1": [r0["k1"], r1["k1"]], "k2": [r0["k2"], r1["k2"]],
               "backend": r0["backend"], "uses_wave": r0["uses_wave"],
               "trees_digest": dig}
        if r0.get("skew"):
            row["skew"] = r0["skew"]
            print(f"parallel {name}: the ranks' s/iter by phase at the last "
                  f"exchange {json.dumps(r0['skew']['ranks'])}, stragglers "
                  f"{r0['skew']['stragglers']} [{kind}, {card}]", flush=True)
        if name.startswith("data"):
            parts = int16_parts if name == "data_int16" else main_parts
            row["legacy_digest"] = [legacy_text_digest(h, parts[1])
                                    for h in head]
            row["equals_single_process"] = [h == parts[0] for h in head]
        rec["modes"][name] = row
        launches[name] = r0["k1"] + r1["k1"] + r0["k2"] + r1["k2"]
        print(f"parallel {name}: 2 ranks on cuda:0 over {row['backend']}, "
              f"s/iter {row['s_per_iter']} (first {row['first_iter_s']}), "
              f"K1 launches {row['k1']}, K2 launches {row['k2']}, "
              f"collectives rank 0 {json.dumps(row['collectives'][0])}; "
              f"trees digests {dig}"
              + (f", legacy digests {row['legacy_digest']}, equal to the "
                 f"one-process run {row['equals_single_process']}"
                 if "legacy_digest" in row else "")
              + f" [{kind}, {card}]", flush=True)
        if dig[0] != dig[1] or r0["model"] != r1["model"]:
            raise AssertionError(f"parallel {name}: the ranks disagree")
        used = row["k1"] if row["uses_wave"] else row["k2"]
        if min(used) == 0:
            raise AssertionError(f"parallel {name}: no kernel launched")
    if rec["modes"]["data_int16"]["legacy_digest"][0] != "614716ef924a0d6e":
        raise AssertionError("parallel data_int16: the trees are not phase "
                             "5's (614716ef924a0d6e)")
    # world size 1 through the same path, in this process
    rec["world_1"] = {}
    for name, parts in (("data_int16", int16_parts),
                        ("data_2xbf16", main_parts)):
        reset_counts(hw, hc)
        bst = lt.train(modes[name], ds, PARALLEL_ROUNDS, device=DEV)
        head = bst.model_to_string().split("\nparameters:")[0]
        w1 = {"legacy_digest": legacy_text_digest(head, parts[1]),
              "equals_single_process": head == parts[0],
              "ranks": bst._gbdt._mesh.size,
              "s_per_iter": round(float(np.median(
                  bst._gbdt.iter_seconds[1:])), 4),
              "k1": hw.hist_wave.launches}
        rec["world_1"][name] = w1
        print(f"parallel {name} at world size 1: legacy digest "
              f"{w1['legacy_digest']}, equal to the one-process run "
              f"{w1['equals_single_process']}, s/iter {w1['s_per_iter']}, "
              f"K1 launches {w1['k1']} [{kind}, {card}]", flush=True)
        if w1["ranks"] != 1 or (name == "data_int16"
                                and not w1["equals_single_process"]):
            raise AssertionError(f"parallel {name} at world size 1 "
                                 "differs from the one-process run")
    # the kernels at the parallel paths' shapes
    half = MAIN_ROWS // 2
    for key, mode, seed in (("k1_dp", "2xbf16", 310),
                            ("k1_dp_int16", "int16", 311)):
        n0 = hw.hist_wave.launches
        tag, res[key] = check_kernel(hw, half, 28, 256, 63, False, mode,
                                     seed)
        res[key].update(tag=tag + " (one rank's rows)",
                        check_launches=hw.hist_wave.launches - n0)
        print_check(res[key], kind, card)
    bins, gv, hv, cv, leaf, slot, _ = wave_inputs(half, 28, 256, 63, False,
                                                  "int16", True, 312)
    args = (bins, gv, hv, cv, leaf, slot, 256)
    exact = hw.hist_wave(*args, highest="int16", num_slots=63, exact=True)
    want = hw.hist_wave_plain(*args, highest="int16", exact=True)
    f32 = hw.hist_wave(*args, highest="int16", num_slots=63)
    ok = (all(torch.equal(a, b) for a, b in zip(exact, want))
          and all(torch.equal(a.float(), b) for a, b in zip(exact, f32)))
    print(f"K1 int16 exact sums (the data-parallel reduction's input) at "
          f"{half:,} x 28 x 256, 63 slots: equal to the plain int64 sums "
          f"and rounding to the kernel's f32 output {ok} [{kind}, {card}]",
          flush=True)
    if not ok:
        raise AssertionError("K1's exact int sums differ")
    n0 = hc.hist_channels.launches
    tag, res["k2_block"] = check_channels(hc, MAIN_ROWS, 14, 256, 32, 313)
    res["k2_block"].update(tag=tag + " (one rank's feature block)",
                           check_launches=hc.hist_channels.launches - n0)
    print_check(res["k2_block"], kind, card)
    secs = time.perf_counter() - t_phase
    rec["phase_31_s"] = round(secs, 1)
    print(f"phase 31: {secs:.1f} s (two ranks {two_s:.1f} s) "
          f"[{kind}, {card}]", flush=True)
    return rec, launches


# ---- the fifteenth slice: the C ABI (34), the board and the window (35) ---
# the C program of phase 34: the headline rows from two raw files through
# the port's loadable C ABI, 5 rounds, predictions and the model to files;
# the embedded interpreter (the ABI library's) prints K1's launches
ABI_PROGRAM = r"""
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include <time.h>

extern const char *LGBM_GetLastError(void);
extern int LGBM_DatasetCreateFromMat(const void *, int, int32_t, int32_t,
                                     int, const char *, const void *,
                                     void **);
extern int LGBM_DatasetSetField(void *, const char *, const void *, int,
                                int);
extern int LGBM_DatasetFree(void *);
extern int LGBM_BoosterCreate(const void *, const char *, void **);
extern int LGBM_BoosterUpdateOneIter(void *, int *);
extern int LGBM_BoosterPredictForMat(void *, const void *, int, int32_t,
                                     int32_t, int, int, int, int,
                                     const char *, int64_t *, double *);
extern int LGBM_BoosterSaveModel(void *, int, int, const char *);
extern int LGBM_BoosterFree(void *);
/* the embedded interpreter the ABI library starts */
extern int PyGILState_Ensure(void);
extern void PyGILState_Release(int);
extern int PyRun_SimpleString(const char *);

#define CHECK(x) do { if ((x) != 0) { \
    fprintf(stderr, "FAIL %s: %s\n", #x, LGBM_GetLastError()); \
    return 1; } } while (0)

static double now(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec + 1e-9 * t.tv_nsec;
}

static void *slurp(const char *path, size_t bytes) {
    void *buf = malloc(bytes);
    FILE *f = fopen(path, "rb");
    if (!buf || !f || fread(buf, 1, bytes, f) != bytes) return NULL;
    fclose(f);
    return buf;
}

int main(int argc, char **argv) {
    /* X.f64 y.f32 pred.f64 model.txt N F params rounds */
    if (argc != 9) return 2;
    int32_t N = atoi(argv[5]), F = atoi(argv[6]);
    int rounds = atoi(argv[8]);
    double *X = slurp(argv[1], sizeof(double) * (size_t)N * F);
    float *y = slurp(argv[2], sizeof(float) * (size_t)N);
    double *pred = malloc(sizeof(double) * (size_t)N);
    if (!X || !y || !pred) { fprintf(stderr, "read failed\n"); return 3; }
    void *ds = NULL, *bst = NULL;
    double t0 = now();
    CHECK(LGBM_DatasetCreateFromMat(X, 1, N, F, 1, argv[7], NULL, &ds));
    CHECK(LGBM_DatasetSetField(ds, "label", y, N, 0));
    double t1 = now();
    CHECK(LGBM_BoosterCreate(ds, argv[7], &bst));
    double t2 = now();
    for (int it = 0; it < rounds; ++it) {
        int fin = 0;
        CHECK(LGBM_BoosterUpdateOneIter(bst, &fin));
    }
    double t3 = now();
    int64_t out_len = 0;
    CHECK(LGBM_BoosterPredictForMat(bst, X, 1, N, F, 1, 0, 0, -1, "",
                                    &out_len, pred));
    double t4 = now();
    if (out_len != N) { fprintf(stderr, "len %lld\n", (long long)out_len);
                        return 4; }
    CHECK(LGBM_BoosterSaveModel(bst, 0, -1, argv[4]));
    FILE *f = fopen(argv[3], "wb");
    if (!f || fwrite(pred, sizeof(double), N, f) != (size_t)N) return 5;
    fclose(f);
    printf("C_ABI dataset_s=%.4f booster_s=%.4f train_s=%.4f "
           "predict_s=%.4f\n", t1 - t0, t2 - t1, t3 - t2, t4 - t3);
    fflush(stdout);
    int st = PyGILState_Ensure();
    PyRun_SimpleString(
        "from lightgbm_tpu_torch import capi\n"
        "from lightgbm_tpu_torch.ops import hist_wave as _h\n"
        "_g = [o.b._gbdt for o in capi._handles.values()"
        " if hasattr(o, 'b')][0]\n"
        "print('C_ABI_K1', _h.hist_wave.launches,"
        " sum(w for w, _ in _g.wave_stats), _g.device, flush=True)\n");
    PyGILState_Release(st);
    CHECK(LGBM_BoosterFree(bst));
    CHECK(LGBM_DatasetFree(ds));
    return 0;
}
"""


def capi_abi_phase(lt, bst, X, y, main_parts, kind, card):
    """(34) A C program linked against the port's loadable C ABI
    (``native.capi_abi_lib``: ``native/capi_abi.c`` built with gcc against
    libpython into ``build/``) trains phase 4's parameters on the headline
    rows, read from raw files, through ``LGBM_DatasetCreateFromMat`` and 5
    ``LGBM_BoosterUpdateOneIter`` calls on the card, predicts every row
    through ``LGBM_BoosterPredictForMat`` and saves the model.  Its trees
    must be phase 4's (legacy digest 28b298b3082595ad), its probabilities
    within 1e-6 of phase 4's ``Booster.predict`` over the same 5 trees;
    the child prints its K1 launches (at least one a wave) and the seconds
    of each step.  Returns (record, K1 launches)."""
    import shutil
    import sysconfig
    from lightgbm_tpu_torch import native
    t_phase = time.perf_counter()
    d = os.path.join(SCRATCH, "capi_abi")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    lib = native.capi_abi_lib()
    build_s = time.perf_counter() - t0
    src = os.path.join(d, "train.c")
    with open(src, "w") as fh:
        fh.write(ABI_PROGRAM)
    exe = os.path.join(d, "train")
    libdir = os.path.dirname(lib)
    pylib = sysconfig.get_config_var("LIBDIR")
    r = subprocess.run(
        ["gcc", "-O1", src, f"-L{libdir}", f"-l:{os.path.basename(lib)}",
         f"-Wl,-rpath,{libdir}", f"-L{pylib}", f"-Wl,-rpath,{pylib}",
         f"-lpython{sysconfig.get_config_var('LDVERSION')}", "-o", exe],
        capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise AssertionError(f"gcc failed on the C program:\n{r.stderr}")
    N, F = X.shape
    paths = [os.path.join(d, n) for n in ("X.f64", "y.f32", "pred.f64",
                                          "model.txt")]
    np.ascontiguousarray(X, np.float64).tofile(paths[0])
    np.ascontiguousarray(y, np.float32).tofile(paths[1])
    # phase 4's parameters as a C API parameter string (on the card)
    cparams = ("objective=binary metric=binary_logloss,auc num_leaves=255 "
               "learning_rate=0.1 max_bin=255 min_data_in_leaf=100 "
               "verbose=-1" + (" device_type=cpu" if DEV == "cpu" else ""))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in sys.path if p and os.path.isdir(p)])
    t0 = time.perf_counter()
    r = subprocess.run([exe, *paths, str(N), str(F), cparams, "5"],
                       capture_output=True, text=True, env=env, timeout=600)
    child_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"the C program failed (rc {r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    steps = dict(kv.split("=") for kv in next(
        ln for ln in lines if ln.startswith("C_ABI ")).split()[1:])
    k1_line = next(ln for ln in lines if ln.startswith("C_ABI_K1")).split()
    k1, waves, dev = int(k1_line[1]), int(k1_line[2]), k1_line[3]
    with open(paths[3]) as fh:
        text = fh.read()
    head = text.split("\nparameters:")[0]
    legacy = legacy_text_digest(head, main_parts[1])
    pred = np.fromfile(paths[2], np.float64)
    want = bst.predict(X, num_iteration=5)
    err = float(np.max(np.abs(pred - want)))
    rec = {"abi_build_s": round(build_s, 2), "child_s": round(child_s, 2),
           "steps_s": {k: float(v) for k, v in steps.items()},
           "k1_launches": k1, "waves": waves, "device": dev,
           "legacy_digest": legacy, "max_abs_err": err,
           "trees_equal": head == main_parts[0]}
    print(f"C ABI: a C program through {os.path.basename(lib)} (built in "
          f"{build_s:.1f} s) on {N:,} x {F} rows on {dev}: dataset "
          f"{steps['dataset_s']} s, booster {steps['booster_s']} s, 5 rounds "
          f"{steps['train_s']} s, predict {steps['predict_s']} s, child "
          f"{child_s:.1f} s; K1 launches {k1} for {waves} waves; legacy "
          f"digest {legacy}, trees equal to phase 4's {rec['trees_equal']};"
          f" predictions max |diff| {err:.3g} against Booster.predict "
          f"[{kind}, {card}]", flush=True)
    if not rec["trees_equal"] or legacy != "28b298b3082595ad":
        raise AssertionError("C ABI: the trees are not phase 4's")
    if err > 1e-6:
        raise AssertionError(f"C ABI: predictions {err} from Booster.predict")
    if k1 < waves or k1 == 0 or not dev.startswith("cuda"):
        raise AssertionError(f"C ABI: K1 launched {k1} times for {waves} "
                             f"waves on {dev}")
    for p in paths[:3]:
        os.remove(p)
    rec["phase_34_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"phase 34: {rec['phase_34_s']} s [{kind}, {card}]", flush=True)
    return rec, k1


def _scrape(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def window_index_add_ms(gb, rows: int) -> float:
    """The ``library_ms`` of a profiler window's K1 work: one
    ``index_add_`` of ``rows`` slotted rows (the window's launches' sum)
    times every feature, (g, h, count) each, into the packed layout's
    ``[F * B * 63, 3]`` f32 cells.  The rows cycle through the training
    rows' bins and gradients, spread over the 63 slots; CUDA events."""
    import torch
    bins = gb._bins_fm                                  # [F, N] on the card
    F, N = bins.shape
    B, S = int(gb.B), 63
    g, h = gb.objective.get_gradients(gb._train_score)
    idx = torch.arange(rows, device=bins.device)
    r = idx % N
    flat_idx = ((torch.arange(F, device=bins.device)[:, None] * B
                 + bins[:, r].long()) * S + (idx % S)[None, :]).reshape(-1)
    src = torch.stack([g.reshape(-1)[r].float(), h.reshape(-1)[r].float(),
                       torch.ones(rows, device=bins.device)], 1)
    src = src[None].expand(F, -1, -1).reshape(-1, 3).contiguous()
    out = torch.zeros((F * B * S, 3), dtype=torch.float32,
                      device=bins.device)
    ms = cuda_ms(lambda: out.index_add_(0, flat_idx, src), reps=5)
    del flat_idx, src, out
    torch.cuda.empty_cache()
    return ms


def board_xprof_phase(lt, hw, hc, params, ds, main_parts, iter_ms, kind,
                      card):
    """(35) The train board and the profiler window on the card.  (a) Phase
    4's training, 5 rounds, with the board alone (``tpu_train_metrics_port
    =0``): s/iter against phase 4's (the board's cost).  (b) 5 rounds with
    the board, telemetry, profile mode and ``tpu_xprof`` (3 iterations,
    2-4: the window opens after two, the JAX package's count):
    ``/metrics`` and ``/progress`` scraped at iteration 2; the trees phase
    4's; K1's ``kernel_measured`` row (the profiler's
    device time of the window's launches, against ``hist_wave_cost``'s
    bound) beside profile mode's CUDA-event time of the same launches; the
    ``reconciliation`` units; the window's iterations against the others;
    ``python -m lightgbm_tpu_torch.obs.report`` over the sink.  (c) The
    serial grower (``feature_fraction_bynode`` 0.5, 31 leaves), 3 rounds
    with a 1-iteration window (iteration 2): K2's ``kernel_measured`` row.
    Returns
    (record, counts of (b), counts of (c))."""
    import shutil
    from lightgbm_tpu_torch import obs
    from lightgbm_tpu_torch.obs import board
    from lightgbm_tpu_torch.obs.report import load_events
    t_phase = time.perf_counter()
    rec = {}
    # (a) the board alone
    reset_counts(hw, hc)
    b_only = lt.train(dict(params, tpu_train_metrics_port=0), ds, 5,
                      valid_sets=[ds], valid_names=["train"], device=DEV)
    rec["board_s_per_iter"] = round(float(np.median(
        b_only._gbdt.iter_seconds[1:])), 4)
    rec["off_s_per_iter"] = round(iter_ms / 1e3, 4)
    if b_only.model_to_string().split("\nparameters:")[0] != main_parts[0]:
        raise AssertionError("board: the trees are not phase 4's")
    del b_only
    # (b) board, telemetry, profile mode and the window
    tel = os.path.join(SCRATCH, "board_xprof")
    shutil.rmtree(tel, ignore_errors=True)
    scraped = {}

    def scrape(env):
        if env.iteration == 2:
            url = board.current().url
            scraped["metrics"] = _scrape(url + "/metrics")
            scraped["progress"] = json.loads(_scrape(url + "/progress"))
    p = dict(params, tpu_train_metrics_port=0, tpu_xprof=True,
             tpu_xprof_iters=3, tpu_telemetry=tel, tpu_profile=True)
    reset_counts(hw, hc)
    t0 = time.perf_counter()
    try:
        bst = lt.train(p, ds, 5, device=DEV, callbacks=[scrape])
    finally:
        obs.disable()
        obs.enable_profile(False)
    wall = time.perf_counter() - t0
    counts = read_counts(hw, hc)
    if bst.model_to_string().split("\nparameters:")[0] != main_parts[0]:
        raise AssertionError("xprof window: the trees are not phase 4's")
    m, pr = scraped.get("metrics", ""), scraped.get("progress", {})
    if "tpu_train_iteration 2" not in m or pr.get("iteration") != 2 \
            or pr.get("total_rounds") != 5:
        raise AssertionError(f"board: mid-run scrape {pr}\n{m[:2000]}")
    series = sorted({ln.split("{")[0].split()[0] for ln in m.splitlines()
                     if ln and not ln.startswith("#")})
    print(f"board at iteration 2: {len(series)} series, "
          + ", ".join(ln for ln in m.splitlines() if ln.startswith((
              "tpu_train_iteration ", "tpu_train_row_iters_per_s ",
              "tpu_train_vs_baseline ", "tpu_train_eta_seconds ",
              "tpu_train_recompiles_total ")))
          + f"; /progress eta {pr.get('eta_s')} s, watchdog "
          f"{pr.get('watchdog')} [{kind}, {card}]", flush=True)
    events = load_events(tel)
    rows = {e["kernel"]: e for e in events
            if e.get("event") == "kernel_measured"}
    k1 = rows.get("lgbm/hist_wave")
    if not k1 or not k1.get("ops") or not k1.get("model_ms"):
        raise AssertionError(f"xprof window: no K1 row in {sorted(rows)}")
    # profile mode's CUDA-event times of the window's launches: the window
    # opens after two iterations (the JAX package's count) and records
    # iterations 2-4, so the kernel_profile events between iteration 1's
    # record and iteration 4's
    it_pos = [i for i, e in enumerate(events)
              if e.get("event") == "iteration"]
    lo, hi = it_pos[1], it_pos[4]
    ev_k1 = [e for e in events[lo:hi]
             if e.get("event") == "kernel_profile"
             and e.get("kernel") == "hist_wave"]
    cuda_event_ms = sum(e["achieved_s"] for e in ev_k1) * 1e3
    gb = bst._gbdt
    iters = [round(s, 4) for s in gb.iter_seconds]
    recon = [e for e in events if e.get("event") == "reconciliation"]
    rec.update(
        xprof_wall_s=round(wall, 2), iter_s=iters,
        window_iter_s=round(float(np.mean(iters[2:5])), 4),
        outside_iter_s=iters[1],
        k1_measured_ms=k1["measured_ms"], k1_kernels=k1["ops"],
        k1_launches_in_window=len(ev_k1), k1_cuda_event_ms=round(
            cuda_event_ms, 4), k1_model_ms=k1["model_ms"],
        k1_roofline_frac=k1["roofline_frac"], k1_bound=k1["bound"],
        window_ms=k1["window_ms"],
        unattributed={k: v["measured_ms"] for k, v in rows.items()
                      if k == "unattributed"},
        reconciliation=[e["units"] for e in recon
                        if e.get("source") == "xprof"],
        scopes={k: v["measured_ms"] for k, v in rows.items()})
    # the library yardstick of the window's K1 work: one index_add_ of as
    # many (row, feature) sums as the window's launches slotted
    rec["k1_window_rows"] = int(sum(r for _, r in gb.wave_stats[2:5]))
    rec["k1_library_ms"] = round(window_index_add_ms(
        gb, rec["k1_window_rows"]), 4)
    print(f"xprof window: index_add_ of the window's {rec['k1_window_rows']}"
          f" slotted rows x {gb._bins_fm.shape[0]} features (g, h, count)"
          f" {rec['k1_library_ms']} ms [{kind}, {card}]", flush=True)
    print(f"xprof window (3 iterations, CPU and CUDA activity): K1 "
          f"{k1['ops']} kernel(s) {k1['measured_ms']} ms by the profiler "
          f"against {rec['k1_cuda_event_ms']} ms by profile mode's CUDA "
          f"events over the same {len(ev_k1)} launches; bound "
          f"{k1['model_ms']} ms ({k1['bound']}), fraction "
          f"{k1['roofline_frac']}; window {k1['window_ms']} ms; scopes "
          f"{rec['scopes']} [{kind}, {card}]", flush=True)
    last = [e for e in recon if e.get("source") != "xprof"][-1]
    print(f"reconciliation (measured / bound): iteration "
          f"{last['iteration']} {json.dumps(last['units'])}; the window's "
          f"{json.dumps(rec['reconciliation'])} [{kind}, {card}]",
          flush=True)
    print(f"xprof window: s/iter {iters} (window iterations 2-4, board, "
          f"telemetry and profile mode on throughout); board alone "
          f"{rec['board_s_per_iter']} s/iter against {rec['off_s_per_iter']}"
          f" with every plane off [{kind}, {card}]", flush=True)
    out = subprocess.run([sys.executable, "-m",
                          "lightgbm_tpu_torch.obs.report", tel],
                         capture_output=True, text=True, cwd=HERE,
                         timeout=300)
    if out.returncode != 0 or "measured roofline" not in out.stdout:
        raise AssertionError(f"report CLI failed:\n{out.stderr[-2000:]}")
    print("report CLI over the sink:\n" + "\n".join(
        out.stdout.splitlines()[:60]), flush=True)
    # (c) the serial grower: K2 under the window
    tel2 = os.path.join(SCRATCH, "board_xprof_serial")
    shutil.rmtree(tel2, ignore_errors=True)
    reset_counts(hw, hc)
    try:
        sb = lt.train(dict(params, feature_fraction_bynode=0.5,
                           num_leaves=31, tpu_xprof=True, tpu_xprof_iters=1,
                           tpu_telemetry=tel2), ds, 3, device=DEV)
    finally:
        obs.disable()
    counts_serial = read_counts(hw, hc)
    if sb._gbdt.uses_wave or counts_serial["k2"] == 0:
        raise AssertionError(f"serial leg: K2 launched "
                             f"{counts_serial['k2']} times")
    rows2 = {e["kernel"]: e for e in load_events(tel2)
             if e.get("event") == "kernel_measured"}
    k2 = rows2.get("lgbm/hist_channels")
    if not k2 or not k2.get("model_ms"):
        raise AssertionError(f"xprof window: no K2 row in {sorted(rows2)}")
    rec.update(k2_measured_ms=k2["measured_ms"], k2_kernels=k2["ops"],
               k2_model_ms=k2["model_ms"],
               k2_roofline_frac=k2["roofline_frac"],
               serial_iter_s=[round(s, 4) for s in sb._gbdt.iter_seconds])
    print(f"xprof window on the serial grower (31 leaves, 1 iteration): K2 "
          f"{k2['ops']} kernel(s) {k2['measured_ms']} ms, bound "
          f"{k2['model_ms']} ms ({k2['bound']}), fraction "
          f"{k2['roofline_frac']}; s/iter {rec['serial_iter_s']}; K2 "
          f"launches {counts_serial['k2']} [{kind}, {card}]", flush=True)
    rec["phase_35_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"phase 35: {rec['phase_35_s']} s [{kind}, {card}]", flush=True)
    return rec, counts, counts_serial


# ---- 36: the tools' fault and chaos matrices on the card ------------------
TOOLS_ROUNDS = 3
TOOLS_LEAVES = 31


def tools_phase(hw, hc, kind, card):
    """(36) The port's tools on the card: the in-process legs of
    ``lightgbm_tpu_torch/tools/fault_matrix.py`` and the seven scenarios
    of ``tools/chaos_serve.py``, at phase 4's data's shapes (1,000,000 x
    28 HIGGS-shaped, seed 0), 3 rounds of 31 leaves.  Every check must
    hold and the training legs must launch K1.  Returns the record."""
    from lightgbm_tpu_torch.tools import chaos_serve, fault_matrix
    t0 = time.perf_counter()
    X, y = higgs_like(MAIN_ROWS)
    reset_counts(hw, hc)
    fm = fault_matrix.run_matrix(DEV, legs="in_process", X=X, y=y,
                                 rounds=TOOLS_ROUNDS,
                                 num_leaves=TOOLS_LEAVES, quiet=True)
    t_fm = time.perf_counter() - t0
    cs = chaos_serve.run_matrix(DEV, X=X, y=y, rounds=TOOLS_ROUNDS,
                                num_leaves=TOOLS_LEAVES, quiet=True)
    counts = read_counts(hw, hc)
    checks = {**{"fault_matrix." + k: v for k, v in fm["checks"].items()},
              **{"chaos_serve." + k: v for k, v in cs["checks"].items()}}
    failed = sorted(k for k, ok in checks.items() if not ok)
    secs = time.perf_counter() - t0
    rec = {"checks_passed": len(checks) - len(failed),
           "checks": len(checks), "failed": failed,
           "k1_launches": counts["k1"],
           "k1_fault_matrix": fm["k1_launches"],
           "k1_chaos_serve": cs["k1_launches"],
           "fault_matrix_s": round(t_fm, 1),
           "chaos_serve_s": round(secs - t_fm, 1),
           "chaos_leg_s": cs["leg_s"], "swap_ms": cs.get("swap_ms"),
           "swap_blip_p99_ms": cs.get("swap_blip_p99_ms"),
           "steady_p99_ms": cs.get("steady_p99_ms"),
           "restart_boot_ms": cs.get("restart_boot_ms"),
           "restart_boot_captures": cs.get("restart_boot_captures"),
           "phase_36_s": round(secs, 1)}
    print(f"tools: {rec['checks_passed']}/{rec['checks']} checks passed "
          f"(fault_matrix {sum(fm['checks'].values())}/{len(fm['checks'])}"
          f" in {rec['fault_matrix_s']} s, chaos_serve "
          f"{sum(cs['checks'].values())}/{len(cs['checks'])} in "
          f"{rec['chaos_serve_s']} s); K1 launches {rec['k1_launches']} "
          f"({rec['k1_fault_matrix']} fault matrix, {rec['k1_chaos_serve']}"
          f" chaos models); phase 36 {rec['phase_36_s']} s [{kind}, {card}]",
          flush=True)
    if failed:
        raise AssertionError(f"tools: checks failed on the card: {failed}")
    if rec["k1_launches"] == 0 or fm["k1_launches"] == 0:
        raise AssertionError(f"tools: the training legs launched no K1 "
                             f"({counts})")
    return rec


# ---- out-of-core ingestion (32), the elastic fleet (33) -------------------
HIGGS_ROWS = 11_000_000          # the HIGGS data set's rows
INGEST_CHUNK_ROWS = 65_536
INGEST_GUARD_ROWS = 1_000_000    # guard 1: the in-memory oracle's rows
FLEET_ROWS = 200_000             # the CLI guard's and the fleet's TSV
# a fleet gather's deadline runs from its first arrival: ranks that start
# CUDA side by side arrive seconds apart, well inside it
FLEET_HEARTBEAT_S = 60


class TimedWalks:
    """A chunk source whose every walk is timed: ingestion walks it twice
    (pass 1 samples, pass 2 bins)."""

    def __init__(self, src):
        self.src = src
        self.walks = []

    def __getattr__(self, name):
        return getattr(self.src, name)

    def __iter__(self):
        t0 = time.perf_counter()
        yield from self.src
        self.walks.append(time.perf_counter() - t0)


def trees_of_file(path) -> str:
    with open(path) as fh:
        return fh.read().split("\nparameters:")[0]


def cli_train(args):
    """``python -m lightgbm_tpu_torch task=train`` in this process (the
    card's context is up already); the log level is kept."""
    from lightgbm_tpu_torch import app
    from lightgbm_tpu_torch.utils import log
    level = log.verbosity()
    try:
        app.main(["task=train", *args])
    finally:
        log.set_verbosity(level)


def ingest_phase(lt, hw, hc, params, res, kind, card):
    """(32) Out-of-core ingestion at HIGGS's size: an 11,000,000 x 28
    HIGGS-shaped ``.npy`` (``higgs_like``, seed 0; 2.46 GB of f64) with a
    ``.y.npy`` sidecar, streamed through ``ingest.open_source`` in
    65,536-row chunks into a memmap-backed bin matrix, then phase 4's
    parameters for 5 rounds on the card.  Prints each pass's seconds and
    rows/s, the ingest's host peak (tracemalloc) against the raw matrix,
    s/iter and K1 at 11M rows against its plain version, ``index_add_`` and
    its bound; train AUC > 0.7.  Guard 1: on the first 1,000,000 rows with
    ``bin_construct_sample_cnt`` at the row count, the streamed dataset
    (bins, mappers, labels) and its trees equal ``from_matrix``'s.  Guard
    2: ``task=train tpu_ingest=true`` on a 200,000 x 28 TSV (seed 2) gives
    the trees of ``task=train``; its model is phase 33's oracle.  Returns
    (record, K1 counts of the 11M training, the TSV, that model)."""
    import tracemalloc

    import torch
    from lightgbm_tpu_torch import ingest
    from lightgbm_tpu_torch.io.dataset import BinnedDataset
    t_phase = time.perf_counter()
    d = os.path.join(SCRATCH, "ingest")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "higgs.npy")
    t0 = time.perf_counter()
    X, y = higgs_like(HIGGS_ROWS)
    raw_bytes = X.nbytes
    np.save(path, X)
    np.save(os.path.join(d, "higgs.y.npy"), y)
    del X, y
    write_s = time.perf_counter() - t0
    p = dict(params, tpu_ingest_chunk_rows=INGEST_CHUNK_ROWS,
             tpu_ingest_memmap=os.path.join(d, "bins.npy"))
    from lightgbm_tpu_torch.config import Config
    src = TimedWalks(ingest.open_source(
        path, Config.from_params(p),
        chunk_rows=ingest.chunk_rows_from_config(Config.from_params(p))))
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    t0 = time.perf_counter()
    ds = ingest.dataset_from_stream(src, p)
    ingest_s = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1] - base
    tracemalloc.stop()
    h = ds._handle
    rec = {"rows": HIGGS_ROWS, "write_s": round(write_s, 1),
           "ingest_s": round(ingest_s, 2),
           "pass_s": [round(w, 2) for w in src.walks],
           "bin_finding_s": round(ingest_s - sum(src.walks), 2),
           "rows_per_s": [round(HIGGS_ROWS / w) for w in src.walks],
           "host_peak_bytes": int(peak), "raw_bytes": int(raw_bytes),
           "bin_bytes": int(h.X_bin.nbytes),
           "memmap": isinstance(h.X_bin, np.memmap)}
    print(f"ingest {HIGGS_ROWS:,} x 28 .npy ({raw_bytes / 1e9:.2f} GB f64, "
          f"written in {write_s:.1f} s): {ingest_s:.2f} s; pass 1 "
          f"{rec['pass_s'][0]} s ({rec['rows_per_s'][0]:,} rows/s), pass 2 "
          f"{rec['pass_s'][1]} s ({rec['rows_per_s'][1]:,} rows/s), bin "
          f"finding on the sample {rec['bin_finding_s']} s; host "
          f"peak {peak / 1e6:.1f} MB (tracemalloc) against the raw "
          f"matrix's {raw_bytes / 1e9:.2f} GB; bins {h.X_bin.dtype} "
          f"{h.X_bin.shape} memmap-backed {rec['memmap']} [{kind}, {card}]",
          flush=True)
    if not rec["memmap"] or len(src.walks) != 2 or peak >= raw_bytes / 4:
        raise AssertionError(f"ingest: not out of core: {rec}")
    bst, counts, curves, iter_ms = train_phase(
        lt, hw, hc, f"ingested {HIGGS_ROWS:,} rows", params, ds, kind, card)
    auc = curves["auc"][-1]
    rec.update(s_per_iter=round(iter_ms / 1e3, 4), auc=auc,
               k1_launches=counts["k1"])
    del bst, ds, h
    torch.cuda.empty_cache()
    if auc <= 0.7:
        raise AssertionError(f"ingested rows: train AUC {auc} <= 0.7")
    n0 = hw.hist_wave.launches
    tag, res["k1_11m"] = check_kernel(hw, HIGGS_ROWS, 28, 256, 63, True,
                                      "2xbf16", 320)
    res["k1_11m"].update(tag=tag + " (the ingested rows)",
                         check_launches=hw.hist_wave.launches - n0)
    print_check(res["k1_11m"], kind, card)
    torch.cuda.empty_cache()

    # guard 1: the first 1M rows, streamed and in memory
    G = INGEST_GUARD_ROWS
    mm = np.load(path, mmap_mode="r")
    yg = np.load(os.path.join(d, "higgs.y.npy"))[:G]
    pg = dict(params, bin_construct_sample_cnt=G)
    streamed = ingest.dataset_from_stream(ingest.ArraySource(
        mm[:G], label=yg, chunk_rows=INGEST_CHUNK_ROWS), pg)
    mem = lt.Dataset(np.asarray(mm[:G]), label=yg, params=pg).construct()
    a, b = streamed._handle, mem._handle
    same_ds = (np.array_equal(a.X_bin, b.X_bin)
               and [m.to_dict() for m in a.bin_mappers]
               == [m.to_dict() for m in b.bin_mappers]
               and np.array_equal(a.metadata.label, b.metadata.label))
    trees = [trees_digest(lt.train(pg, x, 5, device=DEV))
             for x in (streamed, mem)]
    del mm, streamed, mem, a, b
    rec["guard_1"] = {"dataset_equal": bool(same_ds), "trees": trees}
    print(f"ingest guard 1 ({G:,} rows, sample of every row): streamed "
          f"dataset equal to from_matrix's {same_ds}, trees digests "
          f"{trees} [{kind}, {card}]", flush=True)
    if not same_ds or trees[0] != trees[1]:
        raise AssertionError("ingest guard 1: the streamed dataset differs "
                             "from the in-memory one")
    for f in os.listdir(d):
        os.remove(os.path.join(d, f))

    # guard 2: the CLI with and without tpu_ingest on a TSV
    fd = os.path.join(SCRATCH, "fleet")
    os.makedirs(fd, exist_ok=True)
    tsv = os.path.join(fd, "higgs.tsv")
    X, y = higgs_like(FLEET_ROWS, seed=2)
    np.savetxt(tsv, np.column_stack([y, X]), delimiter="\t", fmt="%.9g")
    del X, y
    common = cli_args(tsv)
    out = {}
    for flag in ("false", "true"):
        out[flag] = os.path.join(fd, f"cli_ingest_{flag}.txt")
        cli_train([*common, f"tpu_ingest={flag}",
                   f"output_model={out[flag]}"])
    same_cli = trees_of_file(out["false"]) == trees_of_file(out["true"])
    rec["guard_2"] = same_cli
    print(f"ingest guard 2: task=train tpu_ingest=true on a {FLEET_ROWS:,}"
          f" x 28 TSV gives the trees of task=train {same_cli} "
          f"[{kind}, {card}]", flush=True)
    if not same_cli:
        raise AssertionError("ingest guard 2: tpu_ingest changed the trees")
    rec["phase_32_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"phase 32: {rec['phase_32_s']} s [{kind}, {card}]", flush=True)
    return rec, counts, tsv, out["true"]


def cli_args(tsv, rounds=5):
    """Phase 4's parameters as CLI pairs, on ``tsv``."""
    return [f"data={tsv}", "objective=binary", f"num_iterations={rounds}",
            "num_leaves=255", "max_bin=255", "min_data_in_leaf=100",
            "learning_rate=0.1", "verbosity=-1"]


def fleet_leg(name, params, fleet_dir, world, per_rank_env=None):
    """One gang launch from this process; returns (launch result, seconds,
    events, per-rank stats).  Fails with every rank's log tail."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.fleet.launch import launch_fleet
    t0 = time.perf_counter()
    res = launch_fleet(Config.from_params(params), params,
                       per_rank_env=per_rank_env)
    secs = time.perf_counter() - t0
    ev_path = os.path.join(fleet_dir, "fleet_events.jsonl")
    events = ([json.loads(line) for line in open(ev_path)]
              if os.path.exists(ev_path) else [])
    stats = {}
    for mid in range(world + res["heals"]):
        sp = os.path.join(fleet_dir, f"rank{mid}.stats.json")
        if os.path.exists(sp):
            with open(sp) as fh:
                stats[mid] = json.load(fh)

    def fail(msg):
        tails = []
        for mid in range(world + res["heals"]):
            lp = os.path.join(fleet_dir, f"rank{mid}.log")
            if os.path.exists(lp):
                with open(lp, errors="replace") as fh:
                    tails.append(f"--- rank {mid}\n{fh.read()[-3000:]}")
        raise AssertionError(f"fleet {name}: {msg} ({res})\n"
                             + "\n".join(tails))
    return res, secs, events, stats, fail


def fleet_train_phase(lt, tsv, oracle, kind, card):
    """(33) The fleet on one H100, on phase 32's 200,000 x 28 TSV with
    phase 4's parameters and ``tpu_ingest=true``: (a) ``tpu_fleet=2`` over
    the host transport, 5 rounds: the elected model and each ``.rank{r}``
    copy have the single-process CLI's trees; no ``member_dead``,
    ``resize`` or ``fleet_stall``; (b) the kill leg: 3 ranks, 6 rounds, a
    checkpoint every 2, ``fleet_die`` at iteration 3 on rank 1: rank 1
    exits 137, the fleet 0, the events hold ``member_dead`` and
    ``resize``, the trees are the never-failed single-process model's; (c)
    ``tpu_fleet=2`` with ``auto`` (the device transport here: sharded
    ingest, the data-parallel learner over ``torch.distributed``, both
    ranks on ``cuda:0``) in int16: the ranks' trees equal each other's
    and the single-process int16 CLI model's.  Prints each rank's s/iter,
    start-up seconds and K1 launches.  Returns the record."""
    t_phase = time.perf_counter()
    d = os.path.dirname(tsv)
    base = {"task": "train", "data": tsv, "objective": "binary",
            "num_iterations": "5", "num_leaves": "255", "max_bin": "255",
            "min_data_in_leaf": "100", "learning_rate": "0.1",
            "tpu_ingest": "true", "verbosity": "-1"}
    rec = {}
    legs = (
        ("host_2", 2, dict(base, tpu_fleet="2", tpu_fleet_transport="host"),
         None, oracle),
        ("host_3_kill", 3, dict(base, tpu_fleet="3", num_iterations="6",
                                tpu_checkpoint_freq="2",
                                tpu_fleet_transport="host"),
         {1: {"LGBM_TPU_FAULTS": "fleet_die:raise@iter=3"}}, None),
        ("auto_2_int16", 2, dict(base, tpu_fleet="2",
                                 tpu_fleet_transport="auto",
                                 tpu_hist_dtype="int16"), None, None))
    for name, world, params, env, want in legs:
        fd = os.path.join(d, name)
        params = dict(params, tpu_fleet_dir=fd,
                      tpu_fleet_heartbeat_s=str(FLEET_HEARTBEAT_S),
                      output_model=os.path.join(d, f"{name}.txt"))
        if want is None:
            # the single-process oracle: the same pairs, no fleet
            want = os.path.join(d, f"{name}_oracle.txt")
            cli_train([f"{k}={v}" for k, v in params.items()
                       if k != "task" and not k.startswith("tpu_fleet")
                       and k != "output_model"]
                      + [f"output_model={want}"])
        res, secs, events, stats, fail = fleet_leg(name, params, fd, world,
                                                   env)
        names = [e["name"] for e in events]
        ranks = sorted(stats)
        row = {"s": round(secs, 1), "rcs": res["rcs"], "heals": res["heals"],
               "events": names,
               "s_per_iter": {m: round(float(np.median(
                   stats[m]["iter_s"][1:] or [0])), 4) for m in ranks},
               "startup_s": {m: round(stats[m]["startup_s"], 2)
                             for m in ranks},
               "ingest_s": {m: round(stats[m]["ingest_s"], 2)
                            for m in ranks},
               "k1": {m: stats[m]["k1_launches"] for m in ranks},
               "transport": sorted({stats[m]["transport"] for m in ranks})}
        if not res["ok"]:
            fail("the fleet did not finish")
        want_trees = trees_of_file(want)
        copies = [params["output_model"]] + [
            f"{params['output_model']}.rank{m}" for m in ranks]
        same = [trees_of_file(c) == want_trees for c in copies]
        row["trees_equal_single_process"] = same
        rec[name] = row
        print(f"fleet {name}: {secs:.1f} s, rcs {res['rcs']}, heals "
              f"{res['heals']}, transport {row['transport']}, events "
              f"{names}; per rank s/iter {row['s_per_iter']}, start-up s "
              f"{row['startup_s']}, ingest s {row['ingest_s']}, K1 launches "
              f"{row['k1']}; the elected model and each rank's copy have "
              f"the single-process trees {same} [{kind}, {card}]",
              flush=True)
        if not all(same):
            fail("the trees differ from the single-process model's")
        if min(row["k1"].values()) == 0:
            fail("a rank launched no K1")
        if name == "host_2" and (
                res["rcs"] != {0: 0, 1: 0} or set(names) & {
                    "member_dead", "resize", "fleet_stall"}):
            fail("the healthy fleet lost a rank or stalled")
        if name == "host_3_kill" and not (
                res["rcs"][1] == 137 and res["rc"] == 0
                and "member_dead" in names and "resize" in names):
            fail("the kill leg did not recover as it should")
        if name == "auto_2_int16" and row["transport"] != ["device"]:
            fail("auto did not take the device transport on the card")
        if "fleet_stall" in names:
            print(f"fleet {name}: fleet_stall events "
                  f"{[e for e in events if e['name'] == 'fleet_stall']}",
                  flush=True)
    for f in os.listdir(d):
        path = os.path.join(d, f)
        if os.path.isfile(path):
            os.remove(path)
    rec["phase_33_s"] = round(time.perf_counter() - t_phase, 1)
    print(f"phase 33: {rec['phase_33_s']} s [{kind}, {card}]", flush=True)
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import build
    from lightgbm_tpu_torch.ops import hist_channels as hc
    from lightgbm_tpu_torch.ops import hist_wave as hw

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
          f"{card}", flush=True)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s -> {lib.name}",
          flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)
    census = sass_census(lib)
    print(f"shared-memory atomics in the SASS: {sass_atomics(census)}",
          flush=True)
    print(f"atomics, reductions and warp matches by kernel in the SASS: "
          f"{json.dumps(census)}", flush=True)

    # ---- 2. kernels vs plain ---------------------------------------------
    M = (MAIN_ROWS, 28, 256)
    R = (3001, 5, 64)
    k1_cases = [
        ("k1", M, 63, True, "2xbf16", True, None),
        ("k1_ragged", R, 7, False, "2xbf16", True, None),
        ("k1_int16", M, 63, True, "int16", True, None),
        ("k1_int8_ragged", R, 7, False, "int8", True, None),
        ("k1_triple", M, 42, True, "2xbf16", False, None),
        ("k1_triple_unfused", M, 42, False, "2xbf16", False, None),
        ("k1_triple_int16", M, 42, True, "int16", False, None),
        ("k1_triple_int16_unfused", R, 11, False, "int16", False, None),
        ("k1_high_ids_int16", (50_001, 7, 256), 63, True, "int16", True,
         30_000),
        ("k1_high_ids_2xbf16", (50_001, 7, 256), 40, False, "2xbf16", False,
         30_000),
        # low-cardinality features: many rows reduce into few cells
        ("k1_skew", M, 63, True, "2xbf16", True, None, True),
        ("k1_triple_skew", M, 42, True, "2xbf16", False, None, True),
        ("k1_skew_one_slot", M, 1, True, "2xbf16", True, None, True),
        ("k1_int16_skew", M, 63, True, "int16", True, None, True),
        ("k1_int16_skew_one_slot", M, 1, True, "int16", True, None, True),
        # this slice's paths: the bundled columns (unfused), the mixed
        # width's narrow group (triple, unfused), GOSS-sparse rows
        ("k1_bundled", (MAIN_ROWS, 34, 256), 63, False, "2xbf16", True,
         None, False, None),
        ("k1_triple_narrow", (MAIN_ROWS, 34, 256), 42, False, "2xbf16",
         False, None, False, None),
        ("k1_goss", M, 63, True, "2xbf16", True, None, False, 0.3),
    ]
    res = {}
    for i, (key, (N, F, B), leaves, fused, mode, packed, hi, *extra) in \
            enumerate(k1_cases):
        n0 = hw.hist_wave.launches
        skew, keep = (list(extra) + [False, None])[:2]
        tag, res[key] = check_kernel(hw, N, F, B, leaves, fused, mode, i,
                                     packed=packed, leaf_hi=hi,
                                     skew=bool(skew), keep=keep)
        res[key].update(tag=tag, check_launches=hw.hist_wave.launches - n0)
    for i, (key, (N, F, B), C, *skew) in enumerate((
            ("k2", M, 128), ("k2_ragged", R, 256),
            ("k2_skew", M, 128, True), ("k2_c32", M, 32))):
        n0 = hc.hist_channels.launches
        tag, res[key] = check_channels(hc, N, F, B, C, 100 + i,
                                       skew=bool(skew))
        res[key].update(tag=tag,
                        check_launches=hc.hist_channels.launches - n0)
    for k in res.values():
        print_check(k, kind, card)
    ops3, bytes3 = hc.hist_channels_cost(M[0], M[1], M[2], 3)
    used3 = bound(bytes3, ops3)
    print(f"K2 at C=32 for the serial grower's three channels: bound of the "
          f"3 channels it uses {used3['bound_ms']:.4f} ms, of the 32 it "
          f"reads {res['k2_c32']['bound_ms']:.4f} ms (by "
          f"{res['k2_c32']['bound_by']}) [{kind}, {card}]", flush=True)

    # ---- 3. small-input reference ---------------------------------------
    small_reference(lt)

    # ---- 4. main path ----------------------------------------------------
    X, y = higgs_like(MAIN_ROWS)
    params = {"objective": "binary", "metric": ["binary_logloss", "auc"],
              "num_leaves": 255, "learning_rate": 0.1, "max_bin": 255,
              "min_data_in_leaf": 100, "verbose": -1}
    ds = native_binning(lt, X, y, card)
    bst, counts, curves, iter_ms = train_phase(
        lt, hw, hc, "main path", params, ds, kind, card)
    loss, auc = curves["binary_logloss"], curves["auc"]
    if not all(b < a for a, b in zip(loss, loss[1:])):
        raise AssertionError(f"train logloss did not fall: {loss}")
    if auc[-1] <= 0.7:
        raise AssertionError(f"train AUC {auc[-1]} <= 0.7")
    digest = model_digest(bst)
    main_trees = trees_digest(bst)   # before the profiled 6th iteration
    main_legacy = legacy_digest(bst)
    main_parts = legacy_parts(bst)
    again = train_phase(lt, hw, hc, "main path (repeat)", params, ds, kind,
                        card)[0]
    print(f"main path repeat: model digests {digest} / {model_digest(again)}"
          f" [{kind}, {card}]", flush=True)
    if model_digest(again) != digest:
        raise AssertionError("two 2xbf16 trainings on one Dataset differ")
    del again
    _, k1_f_ms, _ = profile_iteration(bst, iter_ms, kind, card)

    # ---- 5. quantized main path (int16) ----------------------------------
    bst16, counts16, curves16, iter16_ms = train_phase(
        lt, hw, hc, "int16 path", {**params, "tpu_hist_dtype": "int16"}, ds,
        kind, card)
    loss16, auc16 = curves16["binary_logloss"], curves16["auc"]
    if not all(b < a for a, b in zip(loss16, loss16[1:])):
        raise AssertionError(f"int16 train logloss did not fall: {loss16}")
    if abs(auc16[-1] - auc[-1]) > 1e-3:
        raise AssertionError(f"int16 train AUC {auc16[-1]} is not within "
                             f"1e-3 of 2xbf16's {auc[-1]}")
    int16_parts = legacy_parts(bst16)    # before the profiled iteration
    _, k1_q_ms, _ = profile_iteration(bst16, iter16_ms, kind, card)
    print(f"K1 per profiled iteration: int16 {k1_q_ms:.3f} ms vs 2xbf16 "
          f"{k1_f_ms:.3f} ms; s/iter int16 {iter16_ms / 1e3:.4f} vs 2xbf16 "
          f"{iter_ms / 1e3:.4f} [{kind}, {card}]", flush=True)

    # ---- 6. the triple layout's grower path and K2's path -----------------
    counts_triple = triple_path(hw, hc, bst16._gbdt, kind, card)
    counts_k2 = channels_path(hw, hc, bst16._gbdt, kind, card)
    del bst16

    # ---- 7. int8 with bagging --------------------------------------------
    _, counts8, curves8, _ = train_phase(
        lt, hw, hc, "int8 bagging path",
        {**params, "tpu_hist_dtype": "int8", "bagging_fraction": 0.8,
         "bagging_freq": 1}, ds, kind, card)
    auc8 = curves8["auc"]
    if abs(auc8[-1] - auc[-1]) > 1e-2:
        raise AssertionError(f"int8 bagged train AUC {auc8[-1]} is not "
                             f"within 1e-2 of 2xbf16's {auc[-1]}")
    counts_goss = goss_phase(lt, hw, hc, params, ds, kind, card)

    # ---- 8. predict and model text ----------------------------------------
    text = bst.model_to_string()
    if "Tree=4" not in text or "nan" in text.split("end of trees")[0]:
        raise AssertionError("model text is incomplete or not finite")
    predict_phase(lt, bst, X, kind, card)

    # ---- 15-21: DART, RF, TreeSHAP, resume, the guard, the oracles,
    # convert_model ---------------------------------------------------------
    t_slice = time.perf_counter()
    slice_counts = dart_rf_phase(lt, hw, hc, params, ds, X, kind, card)
    shap_main = treeshap_phase(bst, X, "main path", SHAP_ROWS,
                               [(SHAP_ORACLE_ROWS, None)], kind, card)
    counts_resume = resume_phase(lt, hw, hc, params, ds, kind, card)
    guard_phase(lt, params, ds, digest, kind, card)
    counts_overlap = oracle_phase(lt, hw, hc, params, ds, main_trees,
                                  iter_ms, kind, card)
    convert_phase(bst, X, kind, card)
    print(f"phases 15-21: {time.perf_counter() - t_slice:.1f} s "
          f"[{kind}, {card}]", flush=True)

    # ---- 22 (set-up): the served model, trained while the Dataset lives --
    serve_model, serve_cut = serve_model_phase(lt, hw, hc, params, ds, kind,
                                               card)
    routes_s = predict_routes_phase(lt, serve_model, X, kind, card)
    X_serve = X[:SERVE_CHECK_ROWS].copy()

    # ---- (a)-(b) the serial grower; (d) the training API ------------------
    counts_serial, counts_wide, wide_ms, side_ms, wide_bound = serial_phase(
        lt, hw, hc, params, ds, X, y, kind, card)
    counts_cegb = cegb_wave_phase(lt, hw, hc, params, ds, kind, card)
    api_phase(lt, params, ds, X, y, kind, card)

    # ---- 27. the Python API on the card; 28. observability on the card --
    t_obs = time.perf_counter()
    counts_sk, api_s = sklearn_api_phase(lt, hw, hc, X, y, main_trees, kind,
                                         card)
    counts_obs, counts_obs_serial, obs_s_iter, obs_s = obs_phase(
        lt, hw, hc, params, ds, main_trees, main_legacy, kind, card)
    drift_phase(lt, serve_model, X, kind, card)
    print(f"phases 27-28: {time.perf_counter() - t_obs:.1f} s (27: "
          f"{api_s:.1f} s, 28 training: {obs_s:.1f} s) [{kind}, {card}]",
          flush=True)

    # ---- 34. the C ABI; 35. the train board and the profiler window ----
    abi, k1_abi = capi_abi_phase(lt, bst, X, y, main_parts, kind, card)
    board_rec, counts_board, counts_board_serial = board_xprof_phase(
        lt, hw, hc, params, ds, main_parts, iter_ms, kind, card)

    # ---- 31. the learners across ranks --------------------------------
    parallel, parallel_launches = parallel_phase(
        lt, hw, hc, params, ds, X, y, int16_parts, main_parts, res, kind,
        card)
    del X, y, ds

    # ---- 32. out-of-core ingestion at HIGGS's size; 33. the fleet --------
    ingest_rec, counts_ingest, fleet_tsv, fleet_oracle = ingest_phase(
        lt, hw, hc, params, res, kind, card)
    fleet_rec = fleet_train_phase(lt, fleet_tsv, fleet_oracle, kind, card)

    # ---- 9. CLI; (e) sparse input; (f) the CLI on LibSVM -----------------
    cli_model = cli_phase(lt, kind, card)
    sparse_phase(lt, kind, card)
    cli_more_phase(lt, kind, card)

    # ---- 10. categorical + EFB; 11. mixed width ---------------------------
    counts_cat = cat_efb_phase(lt, hw, hc, params, kind, card)
    counts_mixed = mixed_phase(lt, hw, hc, params, kind, card)

    # ---- 12. multiclass; 13. lambdarank; 14. regression --------------------
    counts_multi, shap_multi, multi_tenant = multiclass_phase(
        lt, hw, hc, res, kind, card)
    counts_rank, pair = rank_phase(lt, hw, hc, res, kind, card)
    counts_reg, reg_model = regression_phase(lt, hw, hc, kind, card)

    # ---- 22-26: serving on the card -----------------------------------------
    from lightgbm_tpu_torch.core import forest
    t_serve = time.perf_counter()
    reset_counts(hw, hc)
    walks = {**forest.calls, **forest.arena_calls}
    serve_lat = session_phase(lt, serve_model, X_serve, kind, card)
    fleet = fleet_phase(lt, serve_model, serve_cut, X_serve, kind, card)
    arena_phase(lt, [("serve", serve_model, X_serve),
                     ("multiclass", *multi_tenant),
                     ("weighted_regression", reg_model, X_serve)], kind, card)
    fault_phase(lt, serve_model, X_serve, kind, card)
    serve_cli_phase(lt, serve_model, X_serve, kind, card)
    serve_counts = read_counts(hw, hc)
    walks = {k: {**forest.calls, **forest.arena_calls}[k] - walks[k]
             for k in walks}
    serve_s = time.perf_counter() - t_serve + routes_s
    print(f"phases 22-26: {serve_s:.1f} s (the task=predict routes "
          f"{routes_s:.1f} s of it); hand-kernel "
          f"launches on the serving path {serve_counts} (serving walks the "
          f"forest in torch ops); forest walks in this process {walks} "
          f"[{kind}, {card}]", flush=True)
    if walks["predict"] == 0 or walks["arena"] == 0:
        raise AssertionError(f"the serving phases walked no forest: {walks}")
    serving = {"session_buckets": serve_lat, "fleet": fleet,
               "phases_22_26_s": round(serve_s, 1)}

    # ---- 29: refit and the online loop on the card ----------------------
    t29 = time.perf_counter()
    refit = refit_phase(lt, serve_model, kind, card)
    refit["cli_wall_s"] = cli_refit_phase(lt, cli_model, kind, card)
    refit["online"] = online_phase(lt, serve_model, kind, card)
    k1_continue, continue_s = continue_phase(lt, hw, hc, serve_model, kind,
                                             card)
    refit["continue_s"] = round(continue_s, 2)
    refit["phase_29_s"] = round(time.perf_counter() - t29, 1)
    print(f"phase 29: {refit['phase_29_s']} s [{kind}, {card}]", flush=True)

    # ---- 30: cold restarts of the served model, the serving store -------
    aot = aot_phase(lt, serve_model, kind, card)

    # ---- 36: the tools' fault and chaos matrices --------------------------
    tools = tools_phase(hw, hc, kind, card)

    # launches: each kernel's count in its own path's run (the trainer's
    # phases for K1 packed, the triple grower path, K2's path);
    # training_path_launches: the count summed over the three trainer
    # phases; check_launches: the kernel-vs-plain phase's launches
    def entry(name, key, source, replaces, n, errs, **extra):
        k = res[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": max(res[e]["max_abs_err"] for e in errs),
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k["library_ms"],
                "check_launches": sum(res[e]["check_launches"] for e in errs),
                **extra}

    def on_trainer(key):
        return sum(c[key] for c in (counts, counts16, counts8))

    def skewed(*keys):
        # the skewed-bin cases' numbers, by case
        return {k: {n: res[k][n] for n in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "max_abs_err")}
                for k in keys}
    k1_src = "lightgbm_tpu_torch/csrc/hist_wave.cu"
    k1_at = "lightgbm_tpu/ops/pallas_hist.py:584"
    kernels = [
        entry("hist_wave (K1)", "k1", k1_src, k1_at, counts["k1_packed"],
              ["k1", "k1_ragged", "k1_high_ids_2xbf16", "k1_skew",
               "k1_skew_one_slot"],
              skewed=skewed("k1_skew", "k1_skew_one_slot"),
              cegb_wave_path_launches=counts_cegb["k1_packed"],
              dart_path_launches=slice_counts["dart"][0]["k1_packed"],
              rf_path_launches=slice_counts["rf"][0]["k1_packed"],
              overlap_path_launches=counts_overlap["k1_packed"],
              resume_path_launches=counts_resume["k1_packed"],
              sklearn_path_launches=counts_sk["k1_packed"],
              obs_path_launches=counts_obs["k1_packed"],
              obs_s_per_iter=obs_s_iter,
              online_continue_path_launches=k1_continue,
              data_parallel_path_launches=parallel["modes"][
                  "data_2xbf16"]["k1"],
              data_parallel_unfused=skewed("k1_dp")["k1_dp"],
              ingest_path_launches=counts_ingest["k1_packed"],
              ingested_11m_rows=skewed("k1_11m")["k1_11m"],
              fleet_host_path_launches=fleet_rec["host_2"]["k1"],
              fleet_kill_path_launches=fleet_rec["host_3_kill"]["k1"],
              capi_abi_path_launches=k1_abi,
              xprof_path_launches=counts_board["k1_packed"],
              xprof_window=dict(
                  launches=board_rec["k1_launches_in_window"],
                  measured_ms=board_rec["k1_measured_ms"],
                  cuda_event_ms=board_rec["k1_cuda_event_ms"],
                  bound_ms=board_rec["k1_model_ms"])),
        entry("hist_wave int16 (K1 e)", "k1_int16", k1_src, k1_at,
              counts16["k1_packed"], ["k1_int16", "k1_int8_ragged",
                                      "k1_high_ids_int16",
                                      "k1_triple_int16", "k1_int16_skew",
                                      "k1_int16_skew_one_slot"],
              skewed=skewed("k1_int16_skew", "k1_int16_skew_one_slot"),
              data_parallel_path_launches=parallel["modes"][
                  "data_int16"]["k1"],
              data_parallel_unfused=skewed("k1_dp_int16")["k1_dp_int16"],
              fleet_device_path_launches=fleet_rec["auto_2_int16"]["k1"]),
        entry("hist_wave triple (K1 c)", "k1_triple", k1_src, k1_at,
              counts_triple["k1_triple"], ["k1_triple", "k1_triple_unfused",
                                           "k1_triple_int16_unfused",
                                           "k1_triple_skew"],
              training_path_launches=on_trainer("k1_triple"),
              skewed=skewed("k1_triple_skew")),
        entry("hist_wave unfused packed (K1, EFB bundles)", "k1_bundled",
              k1_src, k1_at, counts_cat["k1_unfused"], ["k1_bundled"]),
        entry("hist_wave triple unfused (K1, mixed width)",
              "k1_triple_narrow", k1_src, k1_at, counts_mixed["k1_triple"],
              ["k1_triple_narrow"]),
        entry("hist_wave packed fused (K1, GOSS)", "k1_goss", k1_src, k1_at,
              counts_goss["k1_packed"], ["k1_goss"]),
        entry("hist_wave unfused packed (K1, multiclass on EFB columns)",
              "k1_multiclass", k1_src, k1_at, counts_multi["k1_unfused"],
              ["k1_multiclass"]),
        entry("hist_wave packed fused (K1, lambdarank at F=136)", "k1_rank",
              k1_src, k1_at, counts_rank["k1_packed"], ["k1_rank"]),
        entry("hist_wave packed fused (K1, weighted regression)", "k1",
              k1_src, k1_at, counts_reg["k1_packed"], ["k1"]),
        entry("hist_channels (K2)", "k2",
              "lightgbm_tpu_torch/csrc/hist_channels.cu",
              "lightgbm_tpu/ops/pallas_hist.py:199", counts_k2["k2"],
              ["k2", "k2_ragged", "k2_skew"],
              training_path_launches=on_trainer("k2"),
              skewed=skewed("k2_skew")),
        entry("hist_channels C=32 (K2, serial grower leaf histograms)",
              "k2_c32", "lightgbm_tpu_torch/csrc/hist_channels.cu",
              "lightgbm_tpu/ops/pallas_hist.py:199", counts_serial["k2"],
              ["k2_c32"], bound_3_channels_ms=used3["bound_ms"],
              all_wide_path_launches=counts_wide["k2"],
              obs_serial_path_launches=counts_obs_serial["k2"],
              wide_histogram_root_ms=wide_ms,
              wide_histogram_bound_ms=wide_bound,
              side_pass_in_its_place_root_ms=side_ms,
              voting_path_launches=parallel["modes"]["voting"]["k2"],
              feature_path_launches=parallel["modes"]["feature"]["k2"],
              feature_block=skewed("k2_block")["k2_block"],
              xprof_serial_path_launches=counts_board_serial["k2"],
              xprof_window=dict(measured_ms=board_rec["k2_measured_ms"],
                                bound_ms=board_rec["k2_model_ms"])),
    ]
    for k in kernels:
        if not all(math.isfinite(k[key]) for key in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "library_ms")):
            raise AssertionError(f"non-finite kernel numbers: {k}")
    print(json.dumps({"pair_pass": pair}), flush=True)
    print(json.dumps({"treeshap": [shap_main, shap_multi]}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"refit": refit}), flush=True)
    print(json.dumps({"aot": aot}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"ingest": ingest_rec, "fleet": fleet_rec}), flush=True)
    print(json.dumps({"capi_abi": abi, "board_xprof": board_rec}),
          flush=True)
    print(json.dumps({"tools": tools}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--aot-child":
        sys.exit(aot_child(sys.argv[2:]))
    sys.exit(main())
