#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile DIR    # also profile a tree fit, a
                                           # forest fit and serving
                                           # (torch.profiler; tables in DIR)

Phases, in order; any failure raises and exits non-zero. Phases 3–7 run
the device engine alone (``refine_depth=None``), as they did before the
refine tail was ported; phases 8–11 run the default fit, whose crown is
built on the card and whose deep tail the native C++ sweep finishes on the
host's cores. Every phase runs the default engine, which is the fused one
(``core/fused_builder.py``) for trees and forests and the levelwise one
for boosting; phase 24 runs the levelwise engine beside it:

1. build: compile every ``mpitree_tpu_torch/csrc/*.cu`` (``histogram.cu``,
   ``traverse.cu``) with ``nvcc`` for ``sm_90a`` into ``build/``, one
   ``nvcc`` per source, started together; then the native split sweep
   (``mpitree_tpu_torch/native/split_kernel.cpp``) with ``g++`` into
   ``build/native/``.
2. kernels: bin ``covtype_like(581_012, seed=0)`` (256 bins) on the card;
   for S in {1, 2, 8, 64, 128, 512, K} (K the fit's chunk width; 2 the
   leaf-wise frontier's sibling pair) spread the
   rows over S slots (some slots empty, some rows at -1) with class
   payloads, hold every histogram route whose tile fits that width, with
   int32 and with byte-wide bins, ``torch.equal`` to the plain version and
   time it behind a device-side hold (a sorted route as a whole, its sort
   included, and its kernel alone on rows ordered beforehand; the sort
   alone too), and time the plain version and one library call
   (``index_put_(..., accumulate=True)`` over prebuilt flat ids) beside
   the least time the card could take for the bytes the planned route
   reads (and, as ``bound_int32_ms``, for 4-byte bins).
3. fit: ``DecisionTreeClassifier(criterion="entropy", max_depth=20,
   max_bins=256)`` on the full matrix, twice; the launch counters are set
   to 0 just before the second fit and read just after it, and every
   route must have launched.
4. parity: ``covtype_like(50_000, seed=2)`` at ``max_depth=10`` on the
   card and with ``device="cpu"`` (the plain versions): the trees must be
   identical field for field, or differ first at a node whose two
   candidate float64 costs are within 1e-12 relative (an exact-tie
   residual: CUDA's and glibc's fp64 ``log`` may differ by an ulp).
5. forest: ``RandomForestClassifier(n_estimators=50, max_depth=12,
   max_bins=256, random_state=0)`` on the first 200,000 rows, twice; the
   histogram launch counters are set to 0 just before the second fit and
   read just after it. Held-out accuracy on ``covtype_like(50_000,
   seed=1)``. Then a 4-tree, depth-8 forest on ``covtype_like(20_000,
   seed=4)`` on the card and with ``device="cpu"``: identical trees.
6. serve kernels: on that forest's flat table, the traversal kernel K4 in
   ``sum`` over the served channel (per-leaf normalized counts), ``norm``
   (counts), ``sum`` (7 and 12 non-integer float64 channels) and
   ``percls`` (7 and 3 columns; 3 does not divide the 50 trees), and the
   quantized kernel K5 in ``sum`` and ``percls`` are held ``torch.equal``
   to their plain versions at 1, 64, 4,096 and 500,000 rows of
   ``covtype_like(500_000, seed=3)``, and timed beside their bound and
   their plain version. A kernel's launches are queued behind a
   device-side hold, so the events bracket device time only (the one-row
   and 64-row shapes average 50 launches per event pair). The served
   channel's K4 and K5 are also run, checked and timed at every forced
   tiling (rows per block), beside the planner's.
7. serve: ``ModelRegistry().publish("rf", forest)`` and
   ``publish("rf8", forest, quantize="int8")``, each answering 300
   one-row, 150 64-row and 30 4,096-row requests (p50/p99 per bucket),
   then one 500,000-row batch (rows/s; and the same batch three times
   more, the pinned slots then in place); the traversal launch counters
   are set to 0 just before the publishes and read after the batch. ``rf``
   must equal ``forest.predict_proba`` bit for bit on 4,096 held-out rows,
   and ``rf8`` must stay within its own exactness report on its
   calibration batch.
8. hybrid fit: the default ``DecisionTreeClassifier(criterion="entropy",
   max_depth=20, max_bins=256)`` on the full matrix, twice: the crown to
   ``round(log2(581_012 / 2048)) = 8`` on the card, one copy of the leaf
   ids, the refine tail on the host. The launch counters are set to 0 just
   before the second fit and read just after; both histogram routes must
   have launched, refine must have engaged at crown depth 8 and added
   nodes. Crown and tail seconds, held-out accuracy beside phase 3's.
9. hybrid parity: ``covtype_like(50_000, seed=2)`` at ``max_depth=20``,
   defaults, on the card and with ``device="cpu"``: identical trees, under
   phase 4's exact-tie rule for a crown node (the tail is the same host
   code on the same rows).
10. default forest: BASELINE config 5 (phase 5's forest) at defaults, once:
    per-tree crowns to depth 7 on the card, tails on the host; wall and
    held-out accuracy.
11. hybrid forest parity: phase 5's 4-tree forest at defaults, so the tail
    engages, on the card and with ``device="cpu"``: identical trees.

Phases 12-15 drive the histogram's fixed-point route, which every
non-integer payload takes (int64 sums, exact and order-independent):

12. fixed-point kernels: three payloads, the moments of
    ``california_like(581_012, seed=0)`` (8 features, 256 bins), the class
    payload of the covtype matrix with weights ``default_rng(2).uniform(
    0.5, 2)``, and a GBDT ``(count, g, h)`` payload; at S in {1, 2, 8, 64,
    128, 512, K} every route that fits, int32 and byte-wide bins: two
    launches ``torch.equal`` to each other and to the plain version; timed
    beside the plain version, one float32 ``index_put_`` and the bound.
13. regression fit: ``DecisionTreeRegressor(max_depth=20, max_bins=256)``
    on that matrix, device engine alone and then at the defaults (crown to
    depth 8 on the card, tail on the host), twice each: identical fits,
    held-out R^2 on ``california_like(50_000, seed=1)``; the launch
    counters around the second fit, both fixed-point routes launched.
14. regression parity, card vs ``device="cpu"``, field for field:
    ``california_like(50_000, seed=2)`` at depth 10, and BASELINE config 4
    as published (``california_like(20_640, seed=0)``, defaults).
15. weights: phase 3's fit with the phase 12 weights, twice (identical, on
    the device engine, fixed-point routes only); card vs CPU at
    ``covtype_like(50_000, seed=2)``, depth 10, same draw (phase 4's tie
    rule); one default ``class_weight="balanced"`` fit.

Phases 16-18 drive per-node feature sampling, random splits and the
regression forests:

16. subspace forests: phase 5's forest with ``max_features="sqrt"``, and
    ``ExtraTreesClassifier`` (random splits, no bootstrap, ``"sqrt"``), on
    the device engine alone, twice each (identical; the launch counters
    around the second fit, both integer routes launched); held-out
    accuracy; then 4 trees of depth 8 on ``covtype_like(20_000, seed=4)``
    on the card and with ``device="cpu"``: identical.
17. regression forests: ``RandomForestRegressor(n_estimators=20,
    max_depth=12, oob_score=True)`` and ``ExtraTreesRegressor(
    n_estimators=20, max_depth=12)`` on phase 13's matrix, device engine
    alone, twice each (identical; the fixed-point routes only); held-out
    R^2 and ``oob_score_``; 4 trees of depth 8 on ``california_like(
    20_000, seed=6)`` on the card and on the CPU: identical.
18. serving a regression forest: ``compile_model`` of phase 17's random
    forest through K4 (``sum`` over float64 leaf means) at 1, 64 and
    4,096 rows equals ``predict`` bit for bit, and through K5
    (``quantize="int8"``) stays within its exactness report; both kernels
    alone at 4,096 rows equal their plain versions, timed beside their
    bound.

Phases 19-20 drive ``monotonic_cst`` and the model files:

19. constrained fits: covtype made binary (the most frequent class
    against the rest, as LIBSVM's ``covtype.binary``) with
    ``monotonic_cst`` +1 on elevation and -1 on the distance to
    roadways, and the California-shaped regressor with +1 on MedInc,
    depth 20, twice each (the launch counters around the second fit);
    held-out accuracy beside an
    unconstrained fit's (R^2 beside phase 13's); ``predict`` monotone
    along each constrained column on 8 anchor rows x 256 points; card vs
    CPU at 50,000 rows, depth 10, field for field with ``value``. Config
    5's forest with the constraint, once (counters around it), served as
    ``forest_values`` through K4 ``sum`` (bit for bit as
    ``predict_proba``) and K5 (int8, within its report) at 1, 64 and
    4,096 rows; both kernels alone at 4,096 rows equal their plain
    versions, timed beside their bound.
20. persistence: ``save_model``/``load_model`` of phase 5's forest and
    phase 19's classifier (into ``build/chip_smoke_models/``):
    ``predict`` and ``predict_proba`` bit for bit; the loaded forest
    served equals the original's served answers; file sizes and seconds.

Phases 21-23 drive gradient boosting (the host round loop; every round's
trees on the card through the fixed-point routes) and its serving:

21. boosting: ``GradientBoostingClassifier()`` at the JAX package's
    defaults (100 rounds, depth 6, learning rate 0.1,
    ``min_samples_leaf=20``, 256 bins) on the full covtype matrix (7
    classes: 700 trees, the host round loop) and
    ``GradientBoostingRegressor()`` on phase 13's matrix (whose defaults
    engage the fused rounds on the card, K = 8), each after a 2-round warm-up fit, the histogram counters set
    to 0 just before the measured fit (fixed-point routes launched, the
    integer routes not); wall, ``fit_stats_`` laps, held-out accuracy on
    phase 3's held-out rows and R^2 on phase 13's, peak device memory.
22. boosting parity: 10 rounds at depth 6 with ``subsample=0.8`` and
    ``colsample_bytree=0.5`` on ``covtype_like(20_000, seed=4)`` (7
    classes, and made binary as phase 19 does) and ``california_like(
    20_000, seed=4)``: two card fits and one ``device="cpu"`` fit,
    identical trees and bit-for-bit margins.
23. boosted serving and files: ``compile_model`` of phase 21's two models
    (kind ``margin``): K4 ``percls`` from the baseline row equals
    ``decision_function`` / ``predict`` bit for bit at 1, 64 and 4,096
    rows, K5 (``quantize="int8"``) within its report; both kernels alone
    at 4,096 rows equal their plain versions, timed beside their bound;
    ``save_model``/``load_model`` of both, answers bit for bit.

Phase 24 compares the engines:

24. engines: phase 3's tree, the first 10 trees of phase 5's forest (a
    10-tree forest draws them alike) and phase 13's regressor (device
    engine alone) under ``MPITREE_TPU_ENGINE=levelwise``, and for the
    tree also with ``MPITREE_TPU_HIST_SUBTRACTION=on`` in both engines,
    once each (the counters around the fit; the fused tree and
    regressor without subtraction are phases 3 and 13): every tree equal
    to the fused one field for field; the fit's wall and launches per
    route; the fused engine's frontier reads (at most one a level); the
    fused builds of phases 3 and 13 with those reads and with the
    frontier sizes given (what the reads cost). Phase 4 is the fused
    engine's card-vs-CPU parity at 50,000 rows.

Phases 25-26 drive best-first growth (``max_leaf_nodes``) and the fused
boosting rounds:

25. leafwise: (a) ``DecisionTreeClassifier(max_depth=12,
    max_leaf_nodes=4096)`` equals the unbudgeted depth-12 tree field for
    field in both leaf-wise engines (fused and host-stepped), and its
    fused build reading the 1-byte ``active`` flag every 16 expansions
    against the fixed trip count of 4,095; (b) ``max_leaf_nodes=255``
    (LightGBM's published ``num_leaves``) unbounded in depth, twice with
    subtraction off and on (the same tree; the counters around the second
    fit; the device-to-host copies of one more fit, profiled), held-out
    accuracy, and its build with flag reads, the fixed trip count and
    subtraction in turns; (c) ``DecisionTreeRegressor(max_leaf_nodes=255)``
    on phase 13's matrix, twice; (d) card vs CPU
    at 50,000 rows, budget 255 (phase 4's tie rule); (e) (b)'s tree
    through ``compile_model`` and its count channel through K4 ``sum``,
    equal to ``predict_proba`` bit for bit.
26. fused rounds: ``GradientBoostingRegressor()`` on phase 13's matrix
    and ``GradientBoostingClassifier(max_leaf_nodes=31)`` on phase 19's
    binary covtype, each at ``rounds_per_dispatch`` 1 and 8 after a
    2-round warm-up: wall, launches, copies per dispatch (and the
    regressor's one 8-round dispatch profiled), held-out R^2 / accuracy;
    the margins of
    K = 8 within 2e-4 of K = 1's, or else the first divergent node a
    near tie of the host loop's own Newton costs (2**-18 relative) with
    the margins before it within 2e-4; the K = 8 ensembles served as
    ``margin`` through K4 (bit for bit) and K5 (within its report).
27. serve tier: (a) phase 5's forest as ``rf`` and ``rf8``; phase 7's
    500,000 rows in 4,096-row batches through ``StreamStage`` at depths
    1, 2 and 4 and a loop of synchronous ``raw`` (wall, rows/s): ``rf``
    equal to ``predict_proba`` bit for bit, ``rf8`` to its own ``raw``,
    and within its report on the calibration batch; (b) with
    ``--profile``, one depth-2 pass traced: the seconds in which a
    host-to-device copy on the copy stream overlaps a traversal kernel;
    (c) ``Scheduler(registry)`` at the default QoS, single-row requests
    (80% ``interactive``) from 4 threads: a closed loop for the sustained
    rate, open loops at 50% and 90% of it (per-class p50/p99, sheds,
    misses, dispatches, mean batch), ``rf8`` too, every answer equal to
    its row's direct ``raw``; a burst of 2 x ``shed_depth`` submissions
    behind a held first dispatch sheds ``queue_full`` and answers every
    admitted one; (d) phase 13's regressor with ``quantize="int8"``
    (report, calibration and held-out deltas, table bytes). The launch
    counters are set to 0 after the reference answers are taken, just
    before each stage pass, the first scheduler run and (d), and read
    after each: the stage, the ``raw`` loop and the scheduler count only
    their own launches.

Phase 28 drives the data mesh (``parallel/``) through
``ParallelDecisionTreeClassifier``, on phase 3's full matrix:

28. mesh: (a) in process, ``n_devices="all"`` on the card (one card: one
    shard, through the mesh code), phase 3's configuration: the tree
    equal to phase 3's field for field; (b) two processes joined by
    gloo, both on ``cuda:0`` (290,506 rows each), the same fit with the
    replication check on (``MPITREE_TPU_DEBUG=1``): both trees equal to
    phase 3's; wall, reductions (calls, bytes, seconds) and each rank's
    launches. Two processes on one card, staged through host memory by
    gloo: this measures invariance, not scaling; (c) one NCCL process
    (``distributed.initialize(backend="nccl")``, world size 1), then
    (a) again: the same tree; (d) two gloo processes at defaults (phase
    8's configuration: crown on the card, tail on the host of each
    process from the gathered leaf ids): both trees equal to phase 8's;
    (e) (a)'s model predicting with its rows sharded: ``predict`` and
    ``predict_proba`` equal to phase 3's bit for bit. The workers of (b)
    and (d) are this script (``--mesh-worker``), which loads the kernels
    phase 1 built and refuses to build them. The launch counters are set
    to 0 before each fit and read after it, in each process.

Phase 29 drives the rest of the mesh (item 14 of ``ROADMAP.md``) in one
pair of gloo processes on ``cuda:0`` (``--mesh-worker ... ensembles``),
each fit compared field for field, in both ranks, with its one-process
twin from this run:

29. mesh ensembles: (a) phase 5's forest (config 5) with ``n_devices=2``:
    a (2, 1) tree mesh, 25 trees a process, then the tree exchange; equal
    to phase 5's forest; (b) the same forest at 2 trees with
    ``MPITREE_TPU_FOREST_HBM_BUDGET=1``: the (1, 2) ``(tree, data)``
    mesh, each tree's histograms reduced over both processes; equal to a
    one-process 2-tree forest; (c) phase 26's
    ``GradientBoostingRegressor()`` at ``rounds_per_dispatch`` 1 and 8 on
    the data mesh: trees and held-out margins equal to phase 26's bit
    for bit; the fused loop's ``graph`` choice recorded; (d) phase 25
    (b)'s 255-leaf tree on the data mesh; (e) phase 3's tree on the
    ``(1, 2)`` ``(data, feature)`` mesh (27 features a process), with
    subtraction off and on, and (c)'s K = 1 ensemble on it; (f) (a)'s
    forest served through K4 (float64) and K5 (int8), equal to phase 5's
    forest served alike. Walls, launches, reductions, winner gathers, row
    routes and the exchange (calls, bytes, seconds) per rank; two
    processes on one card measure invariance, not scaling.

Phase 30 drives the streaming ingest (item 16 of ``ROADMAP.md``): phase
3's matrix written to 8 ``.npy`` shards of X and 8 of y in a temporary
directory, then ``fit(dataset=StreamedDataset...)``, whose chunks are
sketched, binned and copied into their shards on the card:

30. stream: (a) phase 3's fit from ``StreamedDataset.from_npy(...,
    chunk_rows=65_536)``, twice: the tree equal to phase 3's field for
    field, the second fit launching what phase 3's did; ``ingest_stats_``,
    both walls, the device's peak memory and the host's resident-set
    growth over the fit (sampled every 2 ms) beside the 125.5 MB raw
    matrix; (b) the default fit streamed: the refine tail gathers its
    rows by replaying the shards, and the tree equals phase 8's; (c)
    phase 5's forest streamed and its in-memory twin under
    ``MPITREE_TPU_KEYED_BOOTSTRAP=1``: the same trees, both served
    through K4 (float64) and K5 (int8) on 4,096 held-out rows, bit for
    bit; (d) phase 26's ``GradientBoostingRegressor()`` at
    ``rounds_per_dispatch=8`` streamed from phase 13's matrix: margins
    equal to phase 26's K = 8 ensemble bit for bit; (e) a one-shot
    generator of 50,000 rows under ``MPITREE_TPU_SPILL_DIR``: the tree
    of the same rows from ``from_arrays``, ``spill_bytes`` printed; (f)
    two gloo processes on ``cuda:0`` (``--mesh-worker R PORT stream
    OUT``), each streaming its half of the shards (``shard_for_process``,
    290,506 rows) for (a)'s fit on the 2-shard data mesh: both trees equal
    to phase 3's. The launch counters are set to 0 just before each
    measured fit or serve and read just after.

Phase 31 drives resilience (item 17 of ``ROADMAP.md``) on the card: the
ladder of ``mpitree_tpu_torch/resilience/`` through real and injected
faults, and the checkpoints. Every part sets the launch counters to 0
just before it and reads them just after; a part catches only the
``ChaosKilled`` of its own plan and checks that it fired. The host rung
runs only where a part sets ``MPITREE_TPU_ELASTIC=1`` ((c) and (d)):
the script clears the knob at its start and turns the host rung's
warning into an error everywhere else, and every measured fit of phases
1-30 checks that it stayed on the card (no ``device_failovers``, engine
not ``host``):

31. resilience: (a) phase 3's fit under
    ``MPITREE_TPU_CHAOS=dispatch:1:unavailable``: one device retry, the
    tree equal to phase 3's; (b) the levelwise engine with a transient
    fault at level 12: one level retry, levels 12 and on run once more
    and none before, the same tree; (c) phase 4's 50,000-row depth-10
    fit with the caching allocator capped (after binning would fit,
    below the build's peak): a real ``torch.OutOfMemoryError`` classed
    OOM, terminal, raised to the caller under the port's default, and
    with ``MPITREE_TPU_ELASTIC=1`` the host rung grows the card's tree;
    the cap lifted, the card fits it again; (d) the same fit in a child process
    (``--mesh-worker 0 0 sticky OUT``) whose device build first launches
    a Triton kernel reading 4 TiB past a buffer, a real sticky illegal
    memory access: classed terminal, the host rung finishes the fit with
    no further CUDA call, the context stays dead, the child exits 0 with
    the card's tree; (e) phase 5's forest checkpointed and killed at its
    third group's dispatch (``dispatch:3:kill``), then fitted again: it
    resumes after 16 trees, and its 50 trees equal phase 5's and serve
    through K4 bit for bit; shard count and bytes printed; (f) phase
    26's K = 8 regressor checkpointed and killed at round 40
    (``fused_rounds:6:kill``), then fitted again: margins equal phase
    26's bit for bit; (g) ``serving_dispatch:1:unavailable`` on phase
    7's ``rf``: answers bit for bit, ``mpitree_serving_retries_total``
    1; (h) a ``sched_dispatch`` blip requeues the first batch once and
    every answer equals a direct ``raw``; (i) F7 on the card: two gloo
    processes (``--mesh-worker R PORT stream_forest OUT``) stream their
    halves of phase 3's matrix into phase 29 (b)'s 2-tree forest on the
    (1, 2) ``(tree, data)`` mesh: both equal the in-memory keyed twin,
    ``exchange_bytes`` 0 a rank, and each rank's peak device memory is
    printed beside the whole matrix's bytes and phase 29 (b)'s peak.
    Every rung count is printed.

The last line of standard output is ``{"ok": true, "device": {...}}``;
the card's name and power limit, JSON lines of per-shape kernel timings
(``kernel_shapes``, ``serve_kernel_shapes``, ``fixed_kernel_shapes``), of
the serving measurements (``serving``), of the hybrid fits (``hybrid``),
of phases 13 and 15 (``regression``, ``weights``), of phases 16-18
(``subspace_forests``, ``regression_forests``, ``regression_serving``),
of phases 19-20 (``constrained``, ``persistence``), of phases 21-23
(``boosting``), of phase 24 (``engines``), of phases 25-26
(``leafwise``, ``fused_rounds``), of phase 27 (``serve_tier``), of phases
28-29 (``mesh``, ``mesh_ensembles``), of phase 30 (``stream``), of
phase 31 (``resilience``) and one
``kernels`` line (with each
route's launches per engine, and the stream routes at S = 2 of the
leaf-wise pair) come before it.
Without CUDA the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM peaks (data sheet; 700 W): HBM bytes/s and non-tensor fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SLOT_TIERS = (1, 2, 8, 64, 128, 512)
DEV = torch.device("cuda")
ROWS, DEPTH = 581_012, 20  # covtype's rows; the BASELINE fit's depth
# One shape per route for the "kernels" line: stream's one width (the
# root level) and sorted at S=K, the width of the deep levels.
REPRESENTATIVE = {"stream": 1, "sorted": None}
# Device kernels of a profiled run, grouped by what they serve (first match).
PROFILE_KINDS = (
    ("histogram kernels", ("hist_tile_kernel", "hist_zero_split_kernel")),
    ("traversal kernels", ("traverse_kernel",)),
    ("copies", ("Memcpy", "memcpy", "Memset")),
    ("sort/search (binning, level order)",
     ("sort", "Sort", "radix", "Radix", "searchsorted")),
    ("float64 sweep", ("double",)),
)
REPLACES = {
    "stream": "mpitree_tpu/ops/pallas_hist.py:77",
    "sorted": "mpitree_tpu/ops/wide_hist.py:252",
}
# BASELINE config 5, bench.py's FOREST_SHAPES["tpu"]; not cut. Phases 3-7
# pin the device engine alone (DEVICE_ONLY); phases 8-11 run the defaults.
FOREST = dict(n_estimators=50, max_depth=12, max_bins=256, random_state=0)
FOREST_ROWS = 200_000
DEVICE_ONLY = dict(refine_depth=None)
HYBRID_CROWN = 8  # round(log2(ROWS / 2048)), the JAX package's "auto"
SERVE_SHAPES = (1, 64, 4_096, 500_000)  # the buckets, then a batch
SERVE_TILINGS = (1, 2, 4, 8, 16, 32, 64)  # rows per block, beside plan's
# launches averaged per event pair, by rows: a one-row launch is a few us
SERVE_INNER = {1: 50, 64: 50, 4_096: 20, 500_000: 2}
# device-side hold (clock cycles, about 4 ms) while a pair's launches are
# queued: several times the host's time to queue 50 of them
HOLD_CYCLES = 8_000_000
# (bucket rows, requests), as bench_tpu.py's serving section sends them
REQUESTS = ((1, 300), (64, 150), (4_096, 30))
# the serving kernels' kernels-line entries: launch counter -> (mode,
# channel) the served path runs, at the 4,096-row bucket
SERVE_LINE = {"traverse": ("sum", "proba"), "traverse_q": ("sum", "qproba")}
PARITY_FIELDS = ("feature", "threshold", "left", "right", "count",
                 "n_node_samples")
# Phases 12-15: BASELINE config 4's regressor on California-shaped data at
# covtype's row count (20,640 rows, the published size, would give the
# card no real work; phase 14 runs that size too), and phase 3's fit with
# fractional weights. The fixed-point route's "kernels" line shows the
# regression fit's payload: stream at S=1, sorted at S=K.
FIXED_PAYLOADS = ("moments", "class", "gbdt")
FIXED_LINE = {"stream_fixed": 1, "sorted_fixed": None}
CAL_ROWS = 581_012
WEIGHT_LOW, WEIGHT_HIGH = 0.5, 2.0  # default_rng(2).uniform, float32
# Phase 17's regression forests on phase 13's matrix
REG_FOREST = dict(n_estimators=20, max_depth=12, max_bins=256,
                  random_state=0)
GRID = 256  # phase 19's points along a constrained column per anchor row
# Phase 21 fits at the JAX package's defaults (max_iter=100, max_depth=6,
# learning_rate=0.1, min_samples_leaf=20, max_bins=256); phase 22's parity
# fits are cut to 10 rounds on 20,000 rows.
BOOST_ROUNDS = 100
BOOST_PARITY = dict(max_iter=10, max_depth=6, subsample=0.8,
                    colsample_bytree=0.5, random_state=0,
                    rounds_per_dispatch=1)
# Phase 24's runs: (MPITREE_TPU_ENGINE, MPITREE_TPU_HIST_SUBTRACTION), and
# its forest: phase 5's first 10 trees (cut from 50 to keep the script
# within about 300 s; the first trees draw alike in any forest size)
ENGINE_RUNS = (("fused", "off"), ("fused", "on"), ("levelwise", "off"),
               ("levelwise", "on"))
ENGINE_TREES = 10
BOOST_FIELDS = ("feature", "threshold", "left", "right", "count", "value",
                "n_node_samples", "impurity")
# Phase 25: LightGBM's published experiments grow num_leaves=255
# (docs/Experiments.rst); the identity pin's budget is 2**12 at depth 12.
# Phase 26's boosted classifier takes LightGBM's default num_leaves=31
# (sklearn's HistGradientBoosting* max_leaf_nodes), K = 8 the JAX
# package's DEFAULT_ROUNDS_PER_DISPATCH.
LEAF_BUDGET = 255
# Two Newton costs closer than this (relative) are a near tie: float32
# rounding may order them either way (tests/test_torch_boosting.py)
NEAR_TIE = 2.0 ** -18
LEAF_IDENTITY = dict(max_depth=12, max_leaf_nodes=4096)
BOOST_LEAVES = 31
FUSED_K = 8
# Phase 27: phase 7's 500,000 rows in the 4,096-row bucket's batches
# through StreamStage; the scheduler's traffic: single-row requests, 80%
# interactive, from 4 submitter threads, each keeping 32 in flight in the
# closed loop that finds the sustained rate; open loops at 50% and 90% of
# it.
STAGE_BATCH = 4_096
STAGE_DEPTHS = (1, 2, 4)
STAGE_REPS = 3
SCHED_THREADS = 4
SCHED_MIX = 0.8
CLOSED_WINDOW = 32
SCHED_CLOSED = 10_000
SCHED_OPEN = 20_000
SCHED_LOADS = (0.5, 0.9)
# Phase 28: two processes on the one card; (b)'s depth, cut here (never
# its width) if its gloo run outgrows its share of the time limit. Phase
# 29 reuses MESH_RANKS and phase 3's depth for (e), uncut: the whole phase
# fits its 180 s share (PERF.md, phase 29)
MESH_RANKS = 2
MESH_DEPTH = DEPTH
MESH_WORKER_TIMEOUT = 420
STREAM_SHARDS = 8  # .npy shards of X (and of y): half a process in (f)
STREAM_CHUNK = 65_536
SPILL_ROWS = 50_000
TREE_FIELDS = ("feature", "threshold", "left", "right", "parent", "depth",
               "value", "count", "n_node_samples", "impurity")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 7, inner: int = 1, hold: bool = False) -> float:
    """Median device time of one ``fn`` over ``reps`` event pairs (CUDA
    events), each around ``inner`` runs, after one warm-up run. ``hold``
    queues the runs behind a device-side sleep, so the first event fires
    only when all of them are queued and the pair brackets device time, not
    the host's time to launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sass_atomics() -> dict:
    """Shared- and global-memory atomics in the built histogram library's
    SASS (``cuobjdump -sass``), per ``hist_tile_kernel`` instantiation
    ``<bins>/<sorted>/<fixed>``. The fixed-point tiles must add with native
    ``ATOMS.ADD`` and no compare-and-swap loop."""
    import collections
    import re

    from mpitree_tpu_torch import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(_build._library_path("histogram"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*hist_tile_kernelI(\w)Lb([01])ELb([01])E",
                      line)
        if m or "Function :" in line:
            cur = None
            if m:
                cur = "/".join((
                    "uint8" if m.group(1) == "h" else "int32",
                    "sorted" if m.group(2) == "1" else "stream",
                    "fixed" if m.group(3) == "1" else "float"))
                out[cur] = collections.Counter()
            continue
        m = re.search(r"\s((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9.]+)", line)
        if m and cur:
            out[cur][m.group(1)] += 1
    fixed = {k: v for k, v in out.items() if k.endswith("/fixed")}
    if len(fixed) != 4 or any(
            any(op.startswith("ATOMS.CAS") for op in v)
            or not any(op.startswith("ATOMS.ADD") for op in v)
            for v in fixed.values()):
        raise AssertionError(f"fixed-point tiles do not add with native "
                             f"shared atomics: {out}")
    return {k: dict(v) for k, v in out.items()}


def phase_build() -> None:
    from mpitree_tpu_torch import _build, native

    t0 = time.perf_counter()
    names = _build.build_all()
    log(f"sass atomics: {json.dumps(sass_atomics())}")
    t1 = time.perf_counter()
    if native.lib() is None:
        raise AssertionError(
            "the native split sweep is absent (no g++ on PATH, or "
            "MPITREE_TPU_NO_NATIVE set): the default fit's refine tail "
            "needs it")
    log(f"build: csrc/{{{','.join(names)}}}.cu in {t1 - t0:.3f} s (nvcc "
        f"{_build.nvcc_path()}); native split sweep in "
        f"{time.perf_counter() - t1:.3f} s ({shutil.which('g++')}), loaded "
        f"{native.library_path()}")


def _slots(rng, N: int, S: int) -> np.ndarray:
    """Rows spread over S slots, about 1/8 of the slots left empty and 10%
    of the rows parked at -1."""
    live = np.sort(rng.choice(S, size=max(1, S - S // 8), replace=False))
    slot = live[rng.integers(0, len(live), N)].astype(np.int32)
    slot[rng.random(N) < 0.1] = -1
    return slot


def phase_kernels(xb, y_d, B: int, K: int, feat_bins: list) -> list:
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.ops.histogram import class_payload

    N, F = xb.shape
    C = 7
    payload = class_payload(y_d, None, C).contiguous()
    packed = hist_kernel.pack_bins(xb, B)
    rng = np.random.default_rng(0)
    feat = torch.arange(F, device=xb.device, dtype=torch.int64)
    rows = []
    for S in sorted(set(SLOT_TIERS + (K,))):
        slot = torch.from_numpy(_slots(rng, N, S)).to(xb.device)
        planned = hist_kernel.plan(S, F, C, B, feat_bins=feat_bins,
                                   n_rows=N)["route"]
        want = hist_kernel.histogram_reference(xb, payload, slot,
                                               n_slots=S, n_bins=B)
        order, seg = hist_kernel.slot_segments(slot, S)
        torch.cuda.synchronize()
        sort_ms = cuda_ms(lambda: hist_kernel.slot_segments(slot, S),
                          hold=True)

        # Every route whose tile fits this width, with int32 and with
        # byte-wide bins: each is held equal to the plain version and
        # timed (a sorted route as a whole, its sort included, and its
        # kernel alone on rows ordered beforehand), so the plan's choice
        # is checked against the others on every run.
        route_ms = {}
        for route in hist_kernel.ROUTES:
            try:
                hist_kernel.plan(S, F, C, B, route, feat_bins=feat_bins)
            except ValueError:
                continue
            for bins, pk in (("int32", None), ("uint8", packed)):
                cases = {f"{route}/{bins}": {}}
                if route == "sorted":
                    cases[f"{route}/{bins}/presorted"] = dict(
                        order=order, seg_start=seg)
                for name, pre in cases.items():
                    def run(route=route, pk=pk, pre=pre):
                        return hist_kernel.histogram_cuda(
                            xb, payload, slot, n_slots=S, n_bins=B,
                            packed=pk, feat_bins=feat_bins, _variant=route,
                            **pre)
                    got = run()
                    torch.cuda.synchronize()
                    diff = float((got - want).abs().max().item())
                    if name == f"{planned}/uint8":
                        err = diff
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{name} kernel != plain version at S={S} (max "
                            f"|diff| {diff})"
                        )
                    del got
                    route_ms[name] = cuda_ms(run, hold=True)
        del want

        # library yardstick: one index_put_ over prebuilt flat cell ids
        ok = (slot >= 0) & (slot < S)
        r = torch.nonzero(ok).squeeze(1)
        cls = y_d[r]
        ids = (((slot[r].to(torch.int64)[:, None] * F + feat) * C
                + cls[:, None]) * B + xb[r].to(torch.int64)).reshape(-1)
        vals = torch.ones_like(ids, dtype=torch.float32)
        n_in = int(r.numel())

        def library():
            out = torch.zeros(S * F * C * B, dtype=torch.float32,
                              device=xb.device)
            out.index_put_((ids,), vals, accumulate=True)
            return out

        plain_ms = cuda_ms(lambda: hist_kernel.histogram_reference(
            xb, payload, slot, n_slots=S, n_bins=B), reps=5)
        library_ms = cuda_ms(library, reps=5)
        del ids, vals, r, cls

        # Bytes the planned route must move: the slot vector (the sort
        # reads it, or the stream kernel), a padded byte row of bins and
        # the payload of every row in range, the sorted route's order and
        # segment offsets, and the output once. bound_int32 is the same
        # with 4-byte bins and no order: the earlier designs' bound.
        out_bytes = S * F * C * B * 4
        n_bytes = N * 4 + n_in * (packed.shape[1] + C * 4) + out_bytes
        if planned == "sorted":
            n_bytes += n_in * 4 + (S + 1) * 4
        int32_bytes = N * 4 + n_in * (F * 4 + C * 4) + out_bytes
        n_ops = n_in * F  # one add per (row, feature): one nonzero channel
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
        ms = route_ms[f"{planned}/uint8"]
        best = min(v for k, v in route_ms.items()
                   if not k.endswith("/presorted"))
        rows.append(dict(
            S=S, route=planned, rows_in_range=n_in, ms=ms,
            kernel_ms=route_ms.get(f"{planned}/uint8/presorted", ms),
            sort_ms=sort_ms if planned == "sorted" else 0.0,
            plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_int32_ms=max(int32_bytes / HBM_BYTES_PER_S, t_ops) * 1e3,
            max_abs_err=err, route_ms=route_ms, plan_vs_best=ms / best,
        ))
        log(f"kernels: S={S} {planned}: route {ms:.4f} ms (kernel "
            f"{rows[-1]['kernel_ms']:.4f}, sort {sort_ms:.4f}), plain "
            f"{plain_ms:.4f} ms, index_put_ {library_ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}; int32 "
            f"bins {rows[-1]['bound_int32_ms']:.4f}); {ms / best:.3f}x the "
            f"best route; every route equal to plain, ms {route_ms}")
    return rows


# resilience/retry.device_failover's warning, and only its: an error in
# this process outside phase 31 (c)
HOST_RUNG_WARNING = "device failure during"


def _on_card(est, what: str = "") -> None:
    """A fit measured as the card's stayed on the card: no host rung ran."""
    st = getattr(est, "fit_stats_", {})
    if st.get("device_failovers", 0) or st.get("engine") == "host":
        raise AssertionError(
            f"{what or type(est).__name__}: the fit left the card "
            f"(device_failovers {st.get('device_failovers', 0)}, engine "
            f"{st.get('engine')})")


def _fit_twice(est, X, y, *, sample_weight=None, routes=None,
               first: list | None = None):
    """Fit twice; the launch counters are set to 0 just before the second
    fit and read just after it, and every route of ``routes`` (default
    the integer routes) must have launched. ``first`` (a list) receives
    the first fit's tree (a forest's ``trees_``). Returns (first s,
    second s, launches, peak device GiB of the second fit)."""
    from mpitree_tpu_torch.ops import hist_kernel

    t0 = time.perf_counter()
    est.fit(X, y, sample_weight=sample_weight)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _on_card(est)
    if first is not None:
        first.append(est.trees_ if hasattr(est, "trees_") else est.tree_)

    torch.cuda.reset_peak_memory_stats()
    for k in hist_kernel.launches:
        hist_kernel.launches[k] = 0
    t0 = time.perf_counter()
    est.fit(X, y, sample_weight=sample_weight)
    torch.cuda.synchronize()
    second = time.perf_counter() - t0
    _on_card(est)
    launches = dict(hist_kernel.launches)
    missing = [k for k in routes or hist_kernel.ROUTES if launches[k] == 0]
    if missing:
        raise AssertionError(
            f"{type(est).__name__} fit never launched kernel routes "
            f"{missing}")
    return (first_s, second, launches,
            torch.cuda.max_memory_allocated() / 2**30)


def _fit_once(est, X, y, *, routes=None):
    """One fit with the launch counters set to 0 just before it and read
    just after; every route of ``routes`` (default the integer routes)
    must have launched. Returns (wall s, launches)."""
    from mpitree_tpu_torch.ops import hist_kernel

    for k in hist_kernel.launches:
        hist_kernel.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _on_card(est)
    launches = dict(hist_kernel.launches)
    missing = [k for k in routes or hist_kernel.ROUTES if launches[k] == 0]
    if missing:
        raise AssertionError(
            f"{type(est).__name__} fit never launched kernel routes "
            f"{missing}")
    return wall, launches


def _check_fit(clf, X, y, Xh, yh, depth: int):
    """Raw-count predict_proba and a plausible tree grown on the card;
    returns (train acc, held-out acc, predict seconds)."""
    _on_card(clf)
    t0 = time.perf_counter()
    proba = clf.predict_proba(Xh)
    predict_s = time.perf_counter() - t0
    train_acc = clf.score(X, y)
    test_acc = float(np.mean(clf.classes_[proba.argmax(axis=1)] == yh))
    tree = clf.tree_
    leaves = clf.apply(Xh)
    if not (proba.shape == (len(Xh), 7) and proba.dtype == np.int64
            and (proba.sum(axis=1) == tree.n_node_samples[leaves]).all()
            and (tree.feature[leaves] < 0).all()):
        raise AssertionError("predict_proba is not the leaves' raw counts")
    inner = np.flatnonzero(tree.feature >= 0)
    if not (0 < clf.get_depth() <= depth and tree.n_nodes > 1
            and np.isfinite(tree.impurity).all()
            and tree.n_node_samples[0] == len(X)
            and (tree.left[inner] > inner).all()
            and (tree.n_node_samples[tree.left[inner]]
                 + tree.n_node_samples[tree.right[inner]]
                 == tree.n_node_samples[inner]).all()
            and train_acc > 0.5 and test_acc > 0.5):
        raise AssertionError(
            f"implausible fit: depth {clf.get_depth()}, nodes "
            f"{tree.n_nodes}, train {train_acc}, held-out {test_acc}"
        )
    return train_acc, test_acc, predict_s


def phase_fit(X, y, Xh, yh, depth: int):
    from mpitree_tpu_torch.tree import DecisionTreeClassifier

    clf = DecisionTreeClassifier(criterion="entropy", max_depth=depth,
                                 max_bins=256, **DEVICE_ONLY)
    first, second, launches, peak_gib = _fit_twice(clf, X, y)
    train_acc, test_acc, predict_s = _check_fit(clf, X, y, Xh, yh, depth)
    log(f"fit: {len(X)} x {X.shape[1]} depth {depth}: first {first:.3f} s, "
        f"second {second:.3f} s; train acc {train_acc:.6f}, held-out acc "
        f"{test_acc:.6f} ({len(Xh)} rows, predict {predict_s:.3f} s); "
        f"n_nodes {clf.tree_.n_nodes}, depth {clf.get_depth()}, leaves "
        f"{clf.get_n_leaves()}; peak device memory {peak_gib:.3f} GiB; "
        f"launches {launches}; engine {clf.fit_stats_['engine']}")
    return launches, second, test_acc, clf.tree_


def phase_hybrid(X, y, Xh, yh, depth: int, device_acc: float) -> dict:
    """The default fit: crown on the card, refine tail on the host."""
    from mpitree_tpu_torch import native
    from mpitree_tpu_torch.tree import DecisionTreeClassifier

    clf = DecisionTreeClassifier(criterion="entropy", max_depth=depth,
                                 max_bins=256)
    first, second, launches, peak_gib = _fit_twice(clf, X, y)
    st = dict(clf.fit_stats_)
    if not (st.get("crown_depth") == HYBRID_CROWN
            and st.get("refine_engine") == "batched-native"
            and st.get("refine_nodes_added", 0) > 0):
        raise AssertionError(f"refine tail did not engage as expected: {st}")
    train_acc, test_acc, predict_s = _check_fit(clf, X, y, Xh, yh, depth)
    out = dict(first_s=first, second_s=second, **st, n_nodes=clf.tree_.n_nodes,
               depth=clf.get_depth(), leaves=clf.get_n_leaves(),
               train_acc=train_acc, heldout_acc=test_acc,
               device_only_heldout_acc=device_acc, predict_s=predict_s,
               peak_gib=peak_gib, launches=launches,
               native_library=str(native.library_path()))
    log(f"hybrid: {len(X)} x {X.shape[1]} depth {depth} at defaults: first "
        f"{first:.3f} s, second {second:.3f} s (binning "
        f"{st['bin_seconds']:.3f} s, crown to depth {st['crown_depth']} "
        f"{st['crown_seconds']:.3f} s, tail {st['tail_seconds']:.3f} s, of "
        f"which exact per-root binning {st['tail_bin_seconds']:.3f} s and "
        f"C++ sweeps {st['tail_sweep_seconds']:.3f} s: "
        f"{st['refine_candidates']} candidate leaves, "
        f"{st['refine_nodes_added']} nodes added); n_nodes "
        f"{clf.tree_.n_nodes}, depth {clf.get_depth()}; train acc "
        f"{train_acc:.6f}, held-out acc {test_acc:.6f} (device engine "
        f"alone, phase 3: {device_acc:.6f}); peak device memory "
        f"{peak_gib:.3f} GiB; launches {launches}; native library "
        f"{native.library_path()}")
    return out, clf.tree_


def _node_rows(tree, X: np.ndarray, node: int) -> np.ndarray:
    """Rows whose descent passes through ``node`` (its ancestors are the
    same in both trees, so either tree gives the same rows)."""
    from mpitree_tpu_torch.ops.predict import descend

    t = [torch.from_numpy(np.asarray(a)) for a in
         (tree.feature, tree.threshold, tree.left, tree.right)]
    ids = descend(torch.from_numpy(X), t[0].long(), t[1], t[2].long(),
                  t[3].long(), n_steps=int(tree.depth[node]))
    return (ids == node).numpy()


def _same_fields(a, b, fields=PARITY_FIELDS) -> bool:
    return a.n_nodes == b.n_nodes and all(
        np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
        for k in fields)


def _check_parity(gpu, cpu, X, y, what: str, tie_depth: int,
                  sample_weight=None, fields=PARITY_FIELDS) -> None:
    """The card's tree must equal the CPU's in ``fields``, or differ
    first at a node above depth ``tie_depth`` (a split the device engine
    chose on the global bins) whose two candidate float64 costs are within
    1e-12 relative: an exact-tie residual (CUDA's and glibc's fp64 ``log``
    may differ by an ulp). With ``sample_weight`` the costs come from the
    fixed-point route's exact counts, as the fit's did."""
    from mpitree_tpu_torch.ops import hist_kernel, histogram, impurity
    from mpitree_tpu_torch.ops.binning import bin_dataset

    if _same_fields(gpu, cpu, fields):
        log(f"{what}: cuda tree == cpu tree ({gpu.n_nodes} nodes)")
        return
    n = min(gpu.n_nodes, cpu.n_nodes)
    diff = [i for i in range(n) if not all(
        np.array_equal(getattr(gpu, k)[i], getattr(cpu, k)[i],
                       equal_nan=True) for k in fields)]
    node = diff[0] if diff else n
    fa = int(gpu.feature[node]) if node < n else -1
    fb = int(cpu.feature[node]) if node < n else -1
    if fa < 0 or fb < 0 or int(cpu.depth[node]) >= tie_depth:
        raise AssertionError(f"{what}: trees differ structurally at node "
                             f"{node}")
    binned = bin_dataset(X, max_bins=256)
    rows = _node_rows(cpu, X, node)
    w = None if sample_weight is None else torch.from_numpy(
        sample_weight[rows])
    payload = histogram.class_payload(
        torch.from_numpy(y[rows].astype(np.int64)), w,
        gpu.count.shape[1]).contiguous()
    se = histogram.payload_scale(payload)
    hist = hist_kernel.histogram_reference(
        torch.from_numpy(binned.x_binned[rows].astype(np.int32)), payload,
        torch.zeros(int(rows.sum()), dtype=torch.int32), n_slots=1,
        n_bins=binned.n_bins, scale_exp=se)
    hi, lo, _, _ = impurity.cost_sweep_f64(hist, "entropy", se)
    cost = hi.double() + lo.double()

    def cand(tree, f):
        b = np.flatnonzero(binned.thresholds[f] == tree.threshold[node])
        if len(b) != 1:
            raise AssertionError(
                f"{what}: node {node}: threshold {tree.threshold[node]!r} "
                f"is not a candidate of feature {f}"
            )
        return float(cost[0, f, int(b[0])])

    ca, cb = cand(gpu, fa), cand(cpu, fb)
    gap = abs(ca - cb) / max(abs(ca), abs(cb), 1e-300)
    log(f"{what}: first difference at node {node} (depth "
        f"{int(cpu.depth[node])}, {int(rows.sum())} rows): cuda picks "
        f"feature {fa} at f64 cost {ca!r}, cpu picks feature {fb} at "
        f"{cb!r}; relative gap {gap:.3e}")
    if gap >= 1e-12:
        raise AssertionError(
            f"{what}: cuda and cpu trees differ beyond an exact-tie "
            f"residual (relative cost gap {gap:.3e} at node {node})"
        )


def phase_parity(depth: int = 10, hybrid: bool = False) -> None:
    """``covtype_like(50_000, seed=2)`` on the card and with
    ``device="cpu"``: the device engine alone at ``depth``, or (``hybrid``)
    the default fit, whose tail starts below the crown."""
    from mpitree_tpu_torch.tree import DecisionTreeClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(50_000, seed=2)
    kw = dict(criterion="entropy", max_depth=depth, max_bins=256,
              **({} if hybrid else DEVICE_ONLY))
    t0 = time.perf_counter()
    gpu = DecisionTreeClassifier(device="cuda", **kw).fit(X, y)
    t1 = time.perf_counter()
    cpu = DecisionTreeClassifier(device="cpu", **kw).fit(X, y)
    t2 = time.perf_counter()
    crown = cpu.fit_stats_.get("crown_depth", depth)
    if hybrid and not (crown == gpu.fit_stats_.get("crown_depth") == 5
                       and cpu.fit_stats_["refine_nodes_added"] > 0):
        raise AssertionError(f"hybrid parity: refine did not engage: "
                             f"{gpu.fit_stats_} / {cpu.fit_stats_}")
    _check_parity(
        gpu.tree_, cpu.tree_, X, y, tie_depth=crown,
        what=f"{'hybrid parity' if hybrid else 'parity'}: {len(X)} rows "
        f"depth {depth}" + (f" (crown {crown})" if hybrid else "")
        + f", cuda {t1 - t0:.3f} s, cpu {t2 - t1:.3f} s",
    )


def _check_forest(forest, n_trees: int, Xh, yh):
    """A plausible forest grown on the card; returns (held-out acc,
    predict_proba s, nodes per tree, deepest tree)."""
    _on_card(forest)
    t0 = time.perf_counter()
    proba = forest.predict_proba(Xh)
    predict_s = time.perf_counter() - t0
    test_acc = float(np.mean(forest.classes_[proba.argmax(axis=1)] == yh))
    nodes = np.array([t.n_nodes for t in forest.trees_])
    depth = max(t.max_depth for t in forest.trees_)
    if not (len(nodes) == n_trees and nodes.min() > 1
            and depth <= FOREST["max_depth"] and np.isfinite(proba).all()
            and np.allclose(proba.sum(axis=1), 1.0, rtol=0, atol=1e-12)
            and test_acc > 0.5):
        raise AssertionError(
            f"implausible forest: {len(nodes)} trees, nodes {nodes.min()}.."
            f"{nodes.max()}, depth {depth}, held-out {test_acc}"
        )
    return test_acc, predict_s, nodes, depth


def phase_forest(X, y, Xh, yh):
    from mpitree_tpu_torch.tree import RandomForestClassifier

    Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
    forest = RandomForestClassifier(**FOREST, **DEVICE_ONLY)
    first, second, launches, _ = _fit_twice(forest, Xf, yf)
    test_acc, predict_s, nodes, depth = _check_forest(
        forest, FOREST["n_estimators"], Xh, yh)
    log(f"forest: {len(Xf)} x {Xf.shape[1]}, {len(nodes)} trees, depth "
        f"{depth}: first {first:.3f} s, second {second:.3f} s; nodes total "
        f"{int(nodes.sum())}, mean {float(nodes.mean())}; held-out acc "
        f"{test_acc:.6f} ({len(Xh)} rows, predict_proba {predict_s:.3f} s); "
        f"launches {launches}; {forest.fit_stats_['ensemble_path']}")
    return forest, launches, test_acc, second


def phase_default_forest(X, y, Xh, yh, device_acc: float) -> dict:
    """Config 5 at defaults, fitted once: each tree's crown on the card,
    its tail on the host. The launch counters are set to 0 just before."""
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.tree import RandomForestClassifier

    Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
    n_trees = FOREST["n_estimators"]
    forest = RandomForestClassifier(**FOREST)
    for k in hist_kernel.launches:
        hist_kernel.launches[k] = 0
    t0 = time.perf_counter()
    forest.fit(Xf, yf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hist_kernel.launches)
    missing = [k for k in hist_kernel.ROUTES if launches[k] == 0]
    if missing:
        raise AssertionError(f"default forest never launched {missing}")
    st = dict(forest.fit_stats_)
    if not (st.get("crown_depth") == 7 and st["refine_nodes_added"] > 0):
        raise AssertionError(f"default forest: refine did not engage: {st}")
    test_acc, predict_s, nodes, depth = _check_forest(forest, n_trees, Xh,
                                                      yh)
    log(f"default forest: {len(Xf)} x {Xf.shape[1]}, {n_trees} trees, "
        f"depth {depth}, fitted once: {wall:.3f} s (binning "
        f"{st['bin_seconds']:.3f} s, crowns to depth {st['crown_depth']} "
        f"{st['crown_seconds']:.3f} s, tails {st['tail_seconds']:.3f} s, of "
        f"which exact per-root binning {st['tail_bin_seconds']:.3f} s and "
        f"C++ sweeps {st['tail_sweep_seconds']:.3f} s: "
        f"{st['refine_candidates']} candidate leaves, "
        f"{st['refine_nodes_added']} nodes added); nodes total "
        f"{int(nodes.sum())}; held-out acc {test_acc:.6f} (device engine "
        f"alone, phase 5: {device_acc:.6f}; predict_proba {predict_s:.3f} "
        f"s); launches {launches}")
    return dict(wall_s=wall, **st,
                nodes_total=int(nodes.sum()), heldout_acc=test_acc,
                device_only_heldout_acc=device_acc, launches=launches)


def phase_forest_parity(hybrid: bool = False) -> None:
    """A small forest fitted on the card and with ``device="cpu"`` (the
    plain versions): the trees must be identical field for field. With
    ``hybrid`` at defaults, so each tree's tail engages."""
    from mpitree_tpu_torch.tree import RandomForestClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    X, y = covtype_like(20_000, seed=4)
    kw = dict(FOREST, n_estimators=4, max_depth=8,
              **({} if hybrid else DEVICE_ONLY))
    gpu = RandomForestClassifier(device="cuda", **kw).fit(X, y)
    cpu = RandomForestClassifier(device="cpu", **kw).fit(X, y)
    if hybrid and not (gpu.fit_stats_.get("crown_depth") == 3
                       and gpu.fit_stats_["refine_nodes_added"] > 0):
        raise AssertionError(f"hybrid forest parity: refine did not "
                             f"engage: {gpu.fit_stats_}")
    fields = ("feature", "threshold", "left", "right", "count",
              "n_node_samples")
    for i, (a, b) in enumerate(zip(gpu.trees_, cpu.trees_, strict=True)):
        if a.n_nodes != b.n_nodes or not all(
                np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
                for k in fields):
            raise AssertionError(f"forest tree {i}: cuda tree != cpu tree")
    log(f"{'hybrid forest' if hybrid else 'forest'} parity: {len(X)} rows, "
        f"{len(gpu.trees_)} trees depth {kw['max_depth']}: cuda trees == cpu "
        f"trees ({sum(t.n_nodes for t in gpu.trees_)} nodes)")


def _touched(table, cols, X) -> tuple:
    """(distinct nodes on the descent paths of ``X``, distinct leaves
    reached): what a traversal of ``X`` must read of the table."""
    from mpitree_tpu_torch.serving import traversal

    node = traversal.descend(X, *cols, table.n_steps)
    ids = torch.unique(node).cpu().numpy()
    n_leaves = len(ids)
    parent = np.full(table.n_nodes, -1, np.int64)
    inner = np.flatnonzero(table.feature >= 0)
    parent[table.left[inner]] = inner
    parent[table.right[inner]] = inner
    seen = np.zeros(table.n_nodes, bool)
    while ids.size:
        seen[ids] = True
        ids = np.unique(parent[ids])
        ids = ids[ids >= 0]
    return int(seen.sum()), n_leaves


def phase_serve_kernels(forest, Xbig) -> list:
    from mpitree_tpu_torch._device import sm_count
    from mpitree_tpu_torch.serving import quantize, serve_kernel, traversal
    from mpitree_tpu_torch.serving.tables import tables_for

    dev = DEV
    [table] = tables_for(forest.trees_, group_bytes=None)
    cols = table.dev_arrays(dev)[:5]
    record = table.dev_record(dev)
    T, M, C = table.n_trees, table.n_nodes, len(forest.classes_)
    counts = np.concatenate([t.count for t in forest.trees_])
    counts = counts[table.scatter_order()].astype(np.float64)
    rng = np.random.default_rng(0)
    channels = {  # name -> (M, K) float64 values on the card
        "counts": counts,
        "normal": rng.standard_normal((M, C)),
        "normal12": rng.standard_normal((M, 12)),
        "normal1": rng.standard_normal((M, 1)),
    }
    channels = {k: torch.from_numpy(v).to(dev) for k, v in channels.items()}
    channels["proba"] = traversal.normalize_rows(channels["counts"])
    state = quantize.build_state(
        table, quantize.prepare_channel("forest_proba", counts),
        kind="forest_proba", scale=T, n_steps=table.n_steps, tol=1.0,
        device=dev, n_features=Xbig.shape[1],
    )
    qcols = (state.feature, state.threshold, state.left, state.right,
             state.root)
    k4 = (cols, record, 4 + 4 + 4 + 4, 8)
    k5 = (qcols, state.record, 2 + 2 + 4 + 4, 4)
    cases = [  # (form, agg, channel, n_out)
        ("traverse", "sum", "proba", C), ("traverse", "norm", "counts", C),
        ("traverse", "sum", "normal", C), ("traverse", "sum", "normal12", 12),
        ("traverse", "percls", "normal1", C),
        ("traverse", "percls", "normal1", 3),
        ("traverse_q", "sum", "qproba", C),
        ("traverse_q", "percls", "qproba", 3),
    ]
    rows = []
    for N in SERVE_SHAPES:
        X = torch.from_numpy(np.ascontiguousarray(Xbig[:N])).to(dev)
        visited, leaves = _touched(table, cols, X)
        inner = SERVE_INNER[N]
        for form, agg, chan, n_out in cases:
            tcols, rec, node_bytes, acc_bytes = k4 if form == "traverse" \
                else k5
            values = state.qvals if chan == "qproba" else channels[chan]
            kw = dict(n_steps=table.n_steps, agg=agg, n_out=n_out)
            if form == "traverse":
                ref = serve_kernel.traverse_reference
                run = serve_kernel.traverse
            else:
                ref = serve_kernel.traverse_q_reference
                run = serve_kernel.traverse_q
            want = ref(X, *tcols, values, **kw)
            got = run(X, *tcols, values, n_features=X.shape[1], record=rec,
                      **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{form}[{agg}, {chan}] != plain version at N={N} (max "
                    f"|diff| {err})"
                )
            del got
            ms = cuda_ms(lambda: run(X, *tcols, values, n_features=X.shape[1],
                                     record=rec, **kw),
                         reps=5, inner=inner, hold=True)
            plain_ms = cuda_ms(lambda: ref(X, *tcols, values, **kw),
                               reps=3 if N > 4_096 else 5)
            p = serve_kernel.plan(form, N, T, n_out, n_features=X.shape[1],
                                  agg=agg, n_sms=sm_count(dev))
            tiling_ms = {}
            if chan in ("proba", "qproba"):  # the served path
                # every forced tiling equal to plain, and timed
                for R in SERVE_TILINGS:
                    def forced(R=R):
                        return serve_kernel._launch(
                            form, X, tcols, values, rec, **kw,
                            _rows_per_block=R)
                    if not torch.equal(forced(), want):
                        raise AssertionError(
                            f"{form}[{chan}] at {R} rows per block != plain "
                            f"version at N={N}"
                        )
                    tiling_ms[R] = cuda_ms(forced, reps=5, inner=inner,
                                           hold=True)
            del want
            # each input read once, the output written once; of the table
            # only the nodes on this batch's paths and the leaves it reaches
            read = 1 if agg == "percls" else values.shape[1]
            n_bytes = (X.numel() * 4 + visited * node_bytes + T * 4
                       + leaves * read * values.element_size()
                       + N * n_out * acc_bytes)
            rows.append(dict(
                kernel=form, agg=agg, channel=chan, n_out=n_out, rows=N,
                ms=ms, plain_ms=plain_ms,
                bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=n_bytes, visited_nodes=visited, leaves=leaves,
                table_nodes=M, max_abs_err=err, launches_timed=inner,
                plan={k: p[k] for k in ("rows_per_block", "trees_per_chunk",
                                        "threads", "blocks", "smem")},
                tiling_ms=tiling_ms,
            ))
            log(f"serve kernels: {form}[{agg}, {chan}, n_out={n_out}] N={N}: "
                f"kernel {ms:.6f} ms, plain {plain_ms:.4f} ms, bound "
                f"{rows[-1]['bound_ms']:.6f} ms (bytes; {visited} of {M} "
                f"nodes, {leaves} leaves); R={p['rows_per_block']} "
                f"Tc={p['trees_per_chunk']} blocks={p['blocks']}; equal to "
                f"plain" + (f"; rows per block -> ms {tiling_ms}"
                            if tiling_ms else ""))
        del X
    return rows


def phase_serve(forest, Xh, Xbig) -> tuple:
    from mpitree_tpu_torch.serving import ModelRegistry, quantize
    from mpitree_tpu_torch.serving import serve_kernel
    from mpitree_tpu_torch.serving.tables import tables_for

    rng = np.random.default_rng(0)
    for k in serve_kernel.launches:
        serve_kernel.launches[k] = 0
    reg = ModelRegistry()
    stats = {}
    for name, kw in (("rf", {}), ("rf8", {"quantize": "int8"})):
        t0 = time.perf_counter()
        reg.publish(name, forest, **kw)
        publish_s = time.perf_counter() - t0
        lat = {}
        for b, count in REQUESTS:
            times = []
            for _ in range(count):
                lo = int(rng.integers(0, len(Xh) - b + 1))
                t0 = time.perf_counter()
                reg.predict_proba(name, Xh[lo:lo + b])
                times.append(time.perf_counter() - t0)
            ms = np.asarray(times) * 1e3
            lat[b] = dict(p50_ms=float(np.percentile(ms, 50)),
                          p99_ms=float(np.percentile(ms, 99)),
                          requests=count)
        t0 = time.perf_counter()
        out = reg.raw(name, Xbig)
        batch_s = time.perf_counter() - t0
        if out.shape != (len(Xbig), len(forest.classes_)):
            raise AssertionError(f"{name}: batch answer shape {out.shape}")
        # the same batch three more times: the first call also pins the
        # model's slots for 123 chunks
        again = []
        for _ in range(3):
            t0 = time.perf_counter()
            if not np.array_equal(reg.raw(name, Xbig), out):
                raise AssertionError(f"{name}: a repeated batch differs")
            again.append(time.perf_counter() - t0)
        stats[name] = dict(publish_s=publish_s, latency=lat,
                           batch_rows=len(Xbig), batch_s=batch_s,
                           rows_per_s=len(Xbig) / batch_s,
                           repeat_batch_s=again,
                           repeat_rows_per_s=len(Xbig) / statistics.median(
                               again),
                           dispatch=reg.get(name).serve_report_["dispatch"])
        log(f"serve: {name} ({stats[name]['dispatch']}): publish "
            f"{publish_s:.3f} s; " + "; ".join(
                f"bucket {b}: p50 {v['p50_ms']:.4f} ms p99 "
                f"{v['p99_ms']:.4f} ms" for b, v in lat.items())
            + f"; {len(Xbig)} rows in {batch_s:.3f} s = "
            f"{stats[name]['rows_per_s']:.1f} rows/s (repeated: "
            f"{stats[name]['repeat_rows_per_s']:.1f} rows/s)")
    launches = dict(serve_kernel.launches)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"serving never launched {missing}")

    Xc = Xh[:4_096]
    want = forest.predict_proba(Xc)
    got = reg.predict_proba("rf", Xc)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"served rf != forest.predict_proba (max |diff| "
            f"{np.abs(got - want).max()})"
        )
    rep = reg.get("rf8").serve_report_["quantization"]
    [table] = tables_for(forest.trees_, group_bytes=None)
    cal = quantize.synthesize_calibration(table, Xh.shape[1])
    cal_delta = float(np.abs(reg.raw("rf8", cal) - reg.raw("rf", cal)).max())
    # the report compares float32 sums on the host; the served int32 lattice
    # sum and the float64 answer differ from those by float32 rounding
    if not (rep["ok"] and cal_delta <= rep["max_abs_delta"] + 1e-6):
        raise AssertionError(
            f"rf8 outside its exactness report: delta {cal_delta} on the "
            f"calibration batch, report {rep}"
        )
    q = reg.predict_proba("rf8", Xc)
    held_delta = float(np.abs(q - want).max())
    agree = float(np.mean(q.argmax(axis=1) == want.argmax(axis=1)))
    log(f"serve: rf == forest.predict_proba bit for bit on {len(Xc)} "
        f"held-out rows; rf8 calibration delta {cal_delta} <= report "
        f"max_abs_delta {rep['max_abs_delta']} (tolerance "
        f"{rep['tolerance']}); rf8 on held-out rows: max |delta| "
        f"{held_delta}, argmax agreement {agree}; launches {launches}")
    stats["rf8"].update(quantization=rep, calibration_delta=cal_delta,
                        heldout_max_delta=held_delta,
                        heldout_argmax_agreement=agree)
    return stats, launches


def weights(n: int) -> np.ndarray:
    """Phases 12 and 15's fractional weights: ``default_rng(2)`` uniform
    on [0.5, 2), float32."""
    return np.random.default_rng(2).uniform(
        WEIGHT_LOW, WEIGHT_HIGH, n).astype(np.float32)


def phase_fixed_kernels(cov_binned, y_cov, cal_binned, y_cal) -> list:
    """Phase 12: the fixed-point route at every width, for three payloads:
    regression moments (California-shaped, 8 features), fractional class
    weights (covtype, 54 features) and GBDT ``(count, g, h)`` (8 features,
    a fifth of the rows out of the round's sample). Every route whose tile
    fits, with int32 and byte-wide bins: two launches ``torch.equal`` to
    each other and to the plain version; timed as phase 2 times the
    integer routes, beside the plain version, one ``index_put_(...,
    accumulate=True)`` in float32 and the byte bound."""
    from mpitree_tpu_torch.core.builder import BuildConfig, _chunk_size
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.ops import histogram as ph

    rng = np.random.default_rng(12)
    n_cov = y_cov.shape[0]
    cases = {
        "moments": (cal_binned, ph.moment_payload(
            y_cal, torch.ones_like(y_cal))),
        "class": (cov_binned, ph.class_payload(y_cov, torch.from_numpy(
            weights(n_cov)).to(DEV), 7)),
        "gbdt": (cal_binned, ph.gbdt_payload(
            torch.from_numpy(rng.standard_normal(
                y_cal.shape[0]).astype(np.float32)).to(DEV),
            torch.from_numpy(np.where(
                rng.random(y_cal.shape[0]) < 0.2, 0.0,
                rng.uniform(0.05, 0.25, y_cal.shape[0])).astype(
                np.float32)).to(DEV))),
    }
    rows = []
    for name in FIXED_PAYLOADS:
        binned, payload = cases[name]
        payload = payload.contiguous()
        xb = binned.x_binned
        N, F = xb.shape
        B, C = binned.n_bins, payload.shape[1]
        feat_bins = [int(v) + 1 for v in binned.n_cand]
        se = hist_kernel.fixed_point_exponents(payload)
        packed = hist_kernel.pack_bins(xb, B)
        K = _chunk_size(N, F, B, C, BuildConfig(max_depth=DEPTH),
                        cell_bytes=8)
        feat = torch.arange(F, device=DEV, dtype=torch.int64)
        for S in sorted(set(SLOT_TIERS + (K,))):
            slot = torch.from_numpy(_slots(rng, N, S)).to(DEV)
            planned = hist_kernel.plan(S, F, C, B, feat_bins=feat_bins,
                                       n_rows=N, fixed=True)["route"]
            want = hist_kernel.histogram_reference(
                xb, payload, slot, n_slots=S, n_bins=B, scale_exp=se)
            order, seg = hist_kernel.slot_segments(slot, S)
            torch.cuda.synchronize()
            sort_ms = cuda_ms(lambda: hist_kernel.slot_segments(slot, S),
                              hold=True)
            route_ms = {}
            for route in hist_kernel.ROUTES:
                try:
                    hist_kernel.plan(S, F, C, B, route, feat_bins=feat_bins,
                                     fixed=True)
                except ValueError:
                    continue
                for bins, pk in (("int32", None), ("uint8", packed)):
                    variants = {f"{route}/{bins}": {}}
                    if route == "sorted":
                        variants[f"{route}/{bins}/presorted"] = dict(
                            order=order, seg_start=seg)
                    for vname, pre in variants.items():
                        def run(route=route, pk=pk, pre=pre):
                            return hist_kernel.histogram_cuda(
                                xb, payload, slot, n_slots=S, n_bins=B,
                                packed=pk, feat_bins=feat_bins,
                                scale_exp=se, _variant=route, **pre)
                        got, again = run(), run()
                        torch.cuda.synchronize()
                        diff = int((got - want).abs().max())
                        if vname == f"{planned}/uint8":
                            err = float(diff)
                        if not (torch.equal(got, want)
                                and torch.equal(again, got)):
                            raise AssertionError(
                                f"fixed {name} {vname} at S={S}: kernel != "
                                f"plain version or != its own second "
                                f"launch (max |diff| {diff})")
                        del got, again
                        route_ms[vname] = cuda_ms(run, hold=True)

            # library yardstick: one float32 index_put_ over prebuilt flat
            # ids of every nonzero (row, channel), F cells each
            live = ((slot >= 0) & (slot < S))[:, None] & (payload != 0)
            r, c = torch.nonzero(live, as_tuple=True)
            ids = (((slot[r].to(torch.int64)[:, None] * F + feat) * C
                    + c[:, None]) * B + xb[r].to(torch.int64)).reshape(-1)
            vals = payload[r, c][:, None].expand(-1, F).reshape(-1)
            n_in = int(((slot >= 0) & (slot < S)).sum())
            n_nonzero = int(r.numel())

            def library():
                out = torch.zeros(S * F * C * B, dtype=torch.float32,
                                  device=DEV)
                out.index_put_((ids,), vals, accumulate=True)
                return out

            plain_ms = cuda_ms(lambda: hist_kernel.histogram_reference(
                xb, payload, slot, n_slots=S, n_bins=B, scale_exp=se),
                reps=3)
            library_ms = cuda_ms(library, reps=3)
            del ids, vals, r, c, want

            # bytes the planned route must move: the slot vector, a padded
            # byte row of bins and the payload of every row in range, the
            # sorted route's order and segment offsets, the int64 output
            # once; operations: one add per (nonzero value, feature)
            n_bytes = (N * 4 + n_in * (packed.shape[1] + C * 4)
                       + S * F * C * B * 8)
            if planned == "sorted":
                n_bytes += n_in * 4 + (S + 1) * 4
            t_bytes = n_bytes / HBM_BYTES_PER_S
            t_ops = n_nonzero * F / FP32_FLOPS
            ms = route_ms[f"{planned}/uint8"]
            rows.append(dict(
                payload=name, S=S, K=K, route=planned, scale_exp=list(se),
                rows_in_range=n_in, ms=ms,
                kernel_ms=route_ms.get(f"{planned}/uint8/presorted", ms),
                sort_ms=sort_ms if planned == "sorted" else 0.0,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err, route_ms=route_ms,
            ))
            log(f"fixed kernels: {name} S={S} {planned}: route {ms:.4f} ms "
                f"(kernel {rows[-1]['kernel_ms']:.4f}, sort {sort_ms:.4f}), "
                f"plain {plain_ms:.4f} ms, index_put_ {library_ms:.4f} ms, "
                f"bound {rows[-1]['bound_ms']:.4f} ms "
                f"({rows[-1]['bound_by']}); every route equal to plain and "
                f"to its second launch, ms {route_ms}")
        del packed
    return rows


def _r2(y, pred) -> float:
    return 1.0 - float(np.sum((y - pred) ** 2)) / float(
        np.sum((y - y.mean()) ** 2))


def phase_regression(Xc, yc, Xch, ych) -> dict:
    """Phase 13: ``DecisionTreeRegressor(max_depth=20, max_bins=256)`` on
    the California-shaped matrix, device engine alone and then at the
    defaults (crown on the card, tail on the host), twice each: the two
    fits identical field for field; the fixed-point routes must launch in
    the second device-only fit."""
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.tree import DecisionTreeRegressor

    out = {}
    trees = {}
    for mode, kw in (("device", DEVICE_ONLY), ("default", {})):
        reg = DecisionTreeRegressor(max_depth=DEPTH, max_bins=256, **kw)
        first = []
        f1, f2, launches, peak = _fit_twice(
            reg, Xc, yc, first=first,
            routes=hist_kernel.FIXED_ROUTES)
        if not _same_fields(first[0], reg.tree_, PARITY_FIELDS + (
                "value", "impurity")):
            raise AssertionError(f"regression ({mode}): two fits differ")
        t0 = time.perf_counter()
        pred = reg.predict(Xch)
        predict_s = time.perf_counter() - t0
        r2, train_r2 = _r2(ych, pred), reg.score(Xc, yc)
        st = dict(reg.fit_stats_)
        tree = reg.tree_
        if not (st["engine"] == "fused" and np.isfinite(pred).all()
                and pred.shape == ych.shape
                and tree.n_node_samples[0] == len(Xc)
                and 0 < reg.get_depth() <= DEPTH and r2 > 0.5
                and train_r2 > r2):
            raise AssertionError(f"implausible regression fit ({mode}): "
                                 f"R2 {r2}, train {train_r2}, {st}")
        if mode == "default" and not (st.get("crown_depth") == HYBRID_CROWN
                                      and st["refine_nodes_added"] > 0):
            raise AssertionError(f"regression tail did not engage: {st}")
        if mode == "device":
            trees["regressor"] = tree
        out[mode] = dict(first_s=f1, second_s=f2, heldout_r2=r2,
                         train_r2=train_r2, n_nodes=tree.n_nodes,
                         depth=reg.get_depth(), leaves=reg.get_n_leaves(),
                         predict_s=predict_s, peak_gib=peak,
                         launches=launches, **st)
        log(f"regression ({mode}): {len(Xc)} x {Xc.shape[1]} depth {DEPTH}: "
            f"first {f1:.3f} s, second {f2:.3f} s (" + ", ".join(
                f"{k} {v:.3f} s" for k, v in st.items()
                if k.endswith("_seconds")) + f"); two fits identical; "
            f"held-out R2 {r2:.6f} ({len(Xch)} rows), train R2 "
            f"{train_r2:.6f}; n_nodes {tree.n_nodes}, depth "
            f"{reg.get_depth()}; peak device memory {peak:.3f} GiB; "
            f"launches {launches}")
    return out, trees["regressor"]


def phase_regression_parity() -> None:
    """Phase 14: regression trees on the card and with ``device="cpu"``,
    field for field: ``california_like(50_000, seed=2)`` at depth 10
    (device engine alone), and BASELINE config 4 as published,
    ``california_like(20_640, seed=0)`` at the defaults."""
    from mpitree_tpu_torch.tree import DecisionTreeRegressor
    from mpitree_tpu_torch.utils.datasets import california_like

    for n, seed, kw in ((50_000, 2, dict(max_depth=10, **DEVICE_ONLY)),
                        (20_640, 0, {})):
        X, y = california_like(n, seed=seed)
        t0 = time.perf_counter()
        gpu = DecisionTreeRegressor(device="cuda", **kw).fit(X, y)
        t1 = time.perf_counter()
        cpu = DecisionTreeRegressor(device="cpu", **kw).fit(X, y)
        t2 = time.perf_counter()
        if not _same_fields(gpu.tree_, cpu.tree_, PARITY_FIELDS + (
                "value", "impurity", "parent", "depth")):
            raise AssertionError(
                f"regression parity: {n} rows {kw}: cuda tree != cpu tree")
        log(f"regression parity: california_like({n}, seed={seed}) {kw}: "
            f"cuda tree == cpu tree ({gpu.tree_.n_nodes} nodes, depth "
            f"{gpu.get_depth()}); cuda {t1 - t0:.3f} s, cpu "
            f"{t2 - t1:.3f} s; {gpu.fit_stats_}")


def phase_weights(X, y, Xh, yh, device_acc: float) -> dict:
    """Phase 15: phase 3's fit with fractional weights (device engine),
    twice: identical, on the device engine, the fixed-point routes
    launched; card vs CPU at 50,000 rows and depth 10 with the same draw
    (phase 4's tie rule); one default ``class_weight="balanced"`` fit."""
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.tree import DecisionTreeClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    w = weights(len(y))
    clf = DecisionTreeClassifier(criterion="entropy", max_depth=DEPTH,
                                 max_bins=256, **DEVICE_ONLY)
    first = []
    f1, f2, launches, peak = _fit_twice(clf, X, y, sample_weight=w,
                                        first=first,
                                        routes=hist_kernel.FIXED_ROUTES)
    if not _same_fields(first[0], clf.tree_, PARITY_FIELDS + ("impurity",)):
        raise AssertionError("weighted fit: two fits differ")
    if clf.fit_stats_["engine"] != "fused" or any(
            launches[k] for k in hist_kernel.ROUTES):
        raise AssertionError(f"weighted fit left the fixed-point route: "
                             f"{clf.fit_stats_}, {launches}")
    acc = float(np.mean(clf.predict(Xh) == yh))
    out = dict(first_s=f1, second_s=f2, heldout_acc=acc,
               n_nodes=clf.tree_.n_nodes, peak_gib=peak, launches=launches,
               device_only_unweighted_heldout_acc=device_acc)
    log(f"weights: {len(X)} x {X.shape[1]} depth {DEPTH}, weights uniform "
        f"on [{WEIGHT_LOW}, {WEIGHT_HIGH}): first {f1:.3f} s, second "
        f"{f2:.3f} s; two fits identical; engine fused; held-out acc "
        f"{acc:.6f} (unweighted, phase 3: {device_acc:.6f}); n_nodes "
        f"{clf.tree_.n_nodes}; peak {peak:.3f} GiB; launches {launches}")

    Xp, yp = covtype_like(50_000, seed=2)
    wp = weights(len(yp))
    kw = dict(criterion="entropy", max_depth=10, max_bins=256,
              **DEVICE_ONLY)
    t0 = time.perf_counter()
    gpu = DecisionTreeClassifier(device="cuda", **kw).fit(Xp, yp, wp)
    t1 = time.perf_counter()
    cpu = DecisionTreeClassifier(device="cpu", **kw).fit(Xp, yp, wp)
    t2 = time.perf_counter()
    _check_parity(gpu.tree_, cpu.tree_, Xp, yp, tie_depth=10,
                  sample_weight=wp,
                  what=f"weighted parity: {len(Xp)} rows depth 10, cuda "
                  f"{t1 - t0:.3f} s, cpu {t2 - t1:.3f} s")

    bal = DecisionTreeClassifier(criterion="entropy", max_depth=DEPTH,
                                 max_bins=256, class_weight="balanced")
    t0 = time.perf_counter()
    bal.fit(X, y)
    torch.cuda.synchronize()
    bal_s = time.perf_counter() - t0
    bal_acc = float(np.mean(bal.predict(Xh) == yh))
    per_class = {int(c): float(np.mean(bal.predict(Xh[yh == c]) == c))
                 for c in np.unique(yh)}
    out.update(balanced_s=bal_s, balanced_heldout_acc=bal_acc,
               balanced_per_class_recall=per_class,
               balanced_stats=dict(bal.fit_stats_))
    log(f"weights: class_weight='balanced' at defaults: {bal_s:.3f} s, "
        f"held-out acc {bal_acc:.6f}, per-class recall {per_class}; "
        f"{bal.fit_stats_}")
    return out


def _forest_parity(cls, X, y, kw: dict, what: str) -> int:
    """A forest fitted on the card and with ``device="cpu"``: every tree
    identical field for field. Returns the node count."""
    gpu = cls(device="cuda", **kw).fit(X, y)
    cpu = cls(device="cpu", **kw).fit(X, y)
    fields = PARITY_FIELDS + ("value", "impurity", "parent", "depth")
    for i, (a, b) in enumerate(zip(gpu.trees_, cpu.trees_, strict=True)):
        if not _same_fields(a, b, fields):
            raise AssertionError(f"{what}: tree {i}: cuda tree != cpu tree")
    nodes = sum(t.n_nodes for t in gpu.trees_)
    log(f"{what}: {len(X)} rows, {len(gpu.trees_)} trees depth "
        f"{kw['max_depth']}: cuda trees == cpu trees ({nodes} nodes)")
    return nodes


def _same_forests(a, b) -> bool:
    return len(a) == len(b) and all(
        _same_fields(s, t, PARITY_FIELDS + ("value", "impurity"))
        for s, t in zip(a, b))


def phase_subspace_forests(X, y, Xh, yh, bagged_acc: float) -> dict:
    """Phase 16: config 5's forest with ``max_features="sqrt"``, and
    ``ExtraTreesClassifier`` at its defaults, on the device engine alone,
    twice each (the launch counters around the second fit; both integer
    routes launched; the two fits identical); then 4 trees of depth 8 on
    the card and on the CPU: identical."""
    from mpitree_tpu_torch.tree import (
        ExtraTreesClassifier,
        RandomForestClassifier,
    )
    from mpitree_tpu_torch.utils.datasets import covtype_like

    Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
    Xp, yp = covtype_like(20_000, seed=4)
    out = {}
    for name, cls, kw in (
            ("rf_sqrt", RandomForestClassifier, dict(max_features="sqrt")),
            ("extra_trees", ExtraTreesClassifier, {})):
        forest = cls(**FOREST, **DEVICE_ONLY, **kw)
        first = []
        f1, f2, launches, peak = _fit_twice(forest, Xf, yf, first=first)
        if not _same_forests(first[0], forest.trees_):
            raise AssertionError(f"{name}: two fits differ")
        test_acc, predict_s, nodes, depth = _check_forest(
            forest, FOREST["n_estimators"], Xh, yh)
        parity_nodes = _forest_parity(
            cls, Xp, yp, dict(FOREST, n_estimators=4, max_depth=8,
                              **DEVICE_ONLY, **kw),
            what=f"{name} parity")
        out[name] = dict(first_s=f1, second_s=f2, heldout_acc=test_acc,
                         nodes_total=int(nodes.sum()), depth=depth,
                         predict_s=predict_s, peak_gib=peak,
                         launches=launches, parity_nodes=parity_nodes,
                         bagged_heldout_acc=bagged_acc)
        log(f"{name}: {len(Xf)} x {Xf.shape[1]}, {len(nodes)} trees, depth "
            f"{depth}: first {f1:.3f} s, second {f2:.3f} s; two fits "
            f"identical; nodes total {int(nodes.sum())}; held-out acc "
            f"{test_acc:.6f} (bagging alone, phase 5: {bagged_acc:.6f}); "
            f"peak {peak:.3f} GiB; launches {launches}")
    return out


def phase_regression_forests(Xc, yc, Xch, ych) -> tuple:
    """Phase 17: ``RandomForestRegressor`` (20 trees, depth 12, OOB) and
    ``ExtraTreesRegressor`` (20 trees, depth 12) on phase 13's matrix, on
    the device engine alone, twice each: the two fits identical, the
    fixed-point routes launched (counters around the second fit); held-out
    R^2; then 4 trees of depth 8 at 20,000 rows on the card and on the
    CPU: identical. Returns the stats and the fitted random forest."""
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.tree import (
        ExtraTreesRegressor,
        RandomForestRegressor,
    )
    from mpitree_tpu_torch.utils.datasets import california_like

    Xp, yp = california_like(20_000, seed=6)
    kw = dict(REG_FOREST, **DEVICE_ONLY)
    out, rf = {}, None
    for name, cls, extra in (
            ("random_forest", RandomForestRegressor, dict(oob_score=True)),
            ("extra_trees", ExtraTreesRegressor, {})):
        forest = cls(**kw, **extra)
        first = []
        f1, f2, launches, peak = _fit_twice(
            forest, Xc, yc, first=first, routes=hist_kernel.FIXED_ROUTES)
        if not _same_forests(first[0], forest.trees_):
            raise AssertionError(f"regression {name}: two fits differ")
        if any(launches[k] for k in hist_kernel.ROUTES):
            raise AssertionError(f"regression {name} left the fixed-point "
                                 f"route: {launches}")
        t0 = time.perf_counter()
        pred = forest.predict(Xch)
        predict_s = time.perf_counter() - t0
        r2 = _r2(ych, pred)
        nodes = np.array([t.n_nodes for t in forest.trees_])
        oob = getattr(forest, "oob_score_", None)
        if not (len(nodes) == kw["n_estimators"] and nodes.min() > 1
                and np.isfinite(pred).all() and r2 > 0.5
                and (oob is None or 0.5 < oob < 1.0)):
            raise AssertionError(f"implausible regression forest {name}: "
                                 f"R2 {r2}, oob {oob}, nodes {nodes}")
        parity_nodes = _forest_parity(
            cls, Xp, yp, dict(kw, n_estimators=4, max_depth=8, **extra),
            what=f"regression {name} parity")
        out[name] = dict(first_s=f1, second_s=f2, heldout_r2=r2,
                         oob_score=oob, nodes_total=int(nodes.sum()),
                         predict_s=predict_s, peak_gib=peak,
                         launches=launches, parity_nodes=parity_nodes)
        log(f"regression {name}: {len(Xc)} x {Xc.shape[1]}, "
            f"{len(nodes)} trees depth {kw['max_depth']}: first {f1:.3f} s, "
            f"second {f2:.3f} s; two fits identical; held-out R2 {r2:.6f} "
            f"({len(Xch)} rows, predict {predict_s:.3f} s)"
            + ("" if oob is None else f"; oob_score_ {oob:.6f}")
            + f"; nodes total {int(nodes.sum())}; peak {peak:.3f} GiB; "
            f"launches {launches}")
        if rf is None:
            rf = forest
    return out, rf


def _served_kernel_rows(cm, cm8, Xq, what: str, agg: str = "sum") -> dict:
    """K4 (``cm``'s float64 channel) and K5 (``cm8``'s int8 one) in
    ``agg`` mode (``sum``; ``percls`` for a boosted model's margins, K4
    from its baseline row) at 4,096 rows of ``Xq``, each equal to its
    plain version, timed beside its bound and its plain version."""
    from mpitree_tpu_torch.serving import serve_kernel

    N = SERVE_SHAPES[2]
    table = cm.table
    X = torch.from_numpy(np.ascontiguousarray(Xq[:N])).to(DEV)
    cols = table.dev_arrays(DEV)[:5]
    visited, leaves = _touched(table, cols, X)
    T = table.n_trees
    rows = {}
    for form, tcols, values, rec, node_bytes, acc_bytes in (
            ("traverse", cols, cm._values, table.dev_record(DEV),
             16, 8),
            ("traverse_q", (cm8._quant.feature, cm8._quant.threshold,
                            cm8._quant.left, cm8._quant.right,
                            cm8._quant.root), cm8._quant.qvals,
             cm8._quant.record, 12, 4)):
        n_out = cm.n_out if agg == "percls" else values.shape[1]
        kw = dict(n_steps=table.n_steps, agg=agg, n_out=n_out)
        if form == "traverse" and cm._baseline is not None:
            kw["baseline"] = cm._baseline
        run = getattr(serve_kernel, form)
        ref = getattr(serve_kernel, f"{form}_reference")
        want = ref(X, *tcols, values, **kw)
        got = run(X, *tcols, values, n_features=X.shape[1], record=rec, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"{form}[{agg}, {what}] != plain version")
        ms = cuda_ms(lambda: run(X, *tcols, values, n_features=X.shape[1],
                                 record=rec, **kw),
                     reps=5, inner=SERVE_INNER[N], hold=True)
        plain_ms = cuda_ms(lambda: ref(X, *tcols, values, **kw), reps=5)
        n_bytes = (X.numel() * 4 + visited * node_bytes + T * 4
                   + leaves * values.shape[1] * values.element_size()
                   + N * n_out * acc_bytes)
        rows[form] = dict(rows=N, n_out=n_out, agg=agg, ms=ms,
                          plain_ms=plain_ms,
                          bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                          bound_by="bytes", bytes=n_bytes,
                          max_abs_err=float((got - want).abs().max().item()))
        log(f"serve {what}: {form}[{agg}, n_out={n_out}] N={N}: kernel "
            f"{ms:.6f} ms, plain {plain_ms:.4f} ms, bound "
            f"{rows[form]['bound_ms']:.6f} ms; equal to plain")
    return rows


def phase_serve_regression(forest, Xq) -> dict:
    """Phase 18: ``compile_model`` of the phase 17 random forest, served
    through K4 (``sum`` over the trees' float64 leaf means) at 1, 64 and
    4,096 rows, equal to ``forest.predict`` bit for bit, and through K5
    (``quantize="int8"``) within its exactness report; the traversal
    counters are set to 0 just before and both kernels must launch. Then
    both kernels alone at 4,096 rows: equal to their plain versions,
    timed beside their bound."""
    from mpitree_tpu_torch.serving import compile_model, quantize, serve_kernel

    for k in serve_kernel.launches:
        serve_kernel.launches[k] = 0
    cm = compile_model(forest)
    cm8 = compile_model(forest, quantize="int8", quantize_tol=1.0)
    served = {}
    for n in SERVE_SHAPES[:3]:
        t0 = time.perf_counter()
        got = cm.raw(Xq[:n])
        served[n] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, forest.predict(Xq[:n])):
            raise AssertionError(f"served regression forest != predict at "
                                 f"{n} rows")
        cm8.raw(Xq[:n])
    rep = cm8.serve_report_["quantization"]
    cal = quantize.synthesize_calibration(cm8.table, Xq.shape[1])
    cal_delta = float(np.abs(cm8.raw(cal) - cm.raw(cal)).max())
    launches = dict(serve_kernel.launches)
    if not (launches["traverse"] and launches["traverse_q"]):
        raise AssertionError(f"regression serving never launched: "
                             f"{launches}")
    if not (rep["ok"] and cal_delta <= rep["max_abs_delta"] + 1e-6):
        raise AssertionError(f"int8 regression forest outside its report: "
                             f"delta {cal_delta}, report {rep}")

    rows = _served_kernel_rows(cm, cm8, Xq, "regression")
    T = cm.table.n_trees
    out = dict(served_ms=served, launches=launches, kernels=rows,
               quantization=rep, calibration_delta=cal_delta, trees=T)
    log(f"serve regression: {T} trees, exact answers == predict at "
        f"{list(served)} rows (host ms {served}); int8 within its report "
        f"(delta {cal_delta:.6g} <= {rep['max_abs_delta']:.6g}); launches "
        f"{launches}")
    return out


def binary(y: np.ndarray, top: int) -> np.ndarray:
    """LIBSVM's ``covtype.binary``: the most frequent class against the
    rest."""
    return (y == top).astype(np.int64)


def _monotone(est, X, anchors, col: int, sign: int, what: str) -> None:
    """``predict`` along ``GRID`` points of column ``col`` (its range in
    ``X``), the other columns those of each anchor row, must move only in
    the direction of ``sign`` (to 1e-6 of the largest answer: the clip
    bounds are float32, the regressor's exact means float64)."""
    grid = np.linspace(X[:, col].min(), X[:, col].max(),
                       GRID).astype(np.float32)
    rows = np.repeat(anchors, GRID, axis=0)
    rows[:, col] = np.tile(grid, len(anchors))
    pred = np.asarray(est.predict(rows), np.float64).reshape(len(anchors),
                                                             GRID)
    tol = 1e-6 * max(1.0, float(np.abs(pred).max()))
    if not (sign * np.diff(pred, axis=1) >= -tol).all():
        raise AssertionError(f"{what}: predict is not monotone "
                             f"({'+' if sign > 0 else '-'}) along column "
                             f"{col}")


def _constrained_parity(make, X, y, what: str, fields) -> int:
    """A constrained tree on the card and with ``device="cpu"``: equal in
    ``fields`` (phase 4's exact-tie rule for a classifier)."""
    t0 = time.perf_counter()
    gpu = make("cuda").fit(X, y)
    t1 = time.perf_counter()
    cpu = make("cpu").fit(X, y)
    t2 = time.perf_counter()
    if gpu.fit_stats_["engine"] != "fused" or "crown_depth" in gpu.fit_stats_:
        raise AssertionError(f"{what}: not one device-engine build: "
                             f"{gpu.fit_stats_}")
    if hasattr(gpu, "classes_"):
        _check_parity(gpu.tree_, cpu.tree_, X, y, tie_depth=DEPTH,
                      fields=fields,
                      what=f"{what}, cuda {t1 - t0:.3f} s, cpu "
                      f"{t2 - t1:.3f} s")
    elif not _same_fields(gpu.tree_, cpu.tree_, fields):
        raise AssertionError(f"{what}: cuda tree != cpu tree")
    else:
        log(f"{what}: cuda tree == cpu tree ({gpu.tree_.n_nodes} nodes); "
            f"cuda {t1 - t0:.3f} s, cpu {t2 - t1:.3f} s")
    return gpu.tree_.n_nodes


def phase_constrained(X, y, Xh, yh, Xc, yc, Xch, ych, reg_r2: float):
    """Phase 19: ``monotonic_cst`` at full width. A binary covtype
    classifier (+1 on elevation, -1 on the distance to roadways) and a
    California-shaped regressor (+1 on MedInc), depth 20, twice each on
    the card (the launch counters around the second fit); the monotone
    property along each constrained column on 8 anchor rows x ``GRID``
    points; card vs CPU at 50,000 rows, depth 10, field for field with
    ``value``. Then config 5's forest with the constraint, served as
    ``forest_values`` through K4 (bit for bit as ``predict_proba``) and K5
    (int8, within its report). Returns (stats, the classifier, the
    forest)."""
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.serving import compile_model, quantize, serve_kernel
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        DecisionTreeRegressor,
        RandomForestClassifier,
    )
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    top = int(np.bincount(y).argmax())
    yb, yhb = binary(y, top), binary(yh, top)
    cst = np.zeros(X.shape[1], np.int64)
    cst[0], cst[5] = 1, -1
    out = {}
    clf = DecisionTreeClassifier(max_depth=DEPTH, max_bins=256,
                                 monotonic_cst=cst)
    f1, f2, launches, peak = _fit_twice(clf, X, yb)
    acc = float(np.mean(clf.predict(Xh) == yhb))
    plain = DecisionTreeClassifier(max_depth=DEPTH, max_bins=256,
                                   **DEVICE_ONLY).fit(X, yb)
    plain_acc = float(np.mean(plain.predict(Xh) == yhb))
    for col, sign in ((0, 1), (5, -1)):
        _monotone(clf, X, Xh[:8], col, sign, "constrained classifier")
    Xp, yp = covtype_like(50_000, seed=2)
    parity = _constrained_parity(
        lambda d: DecisionTreeClassifier(max_depth=10, max_bins=256,
                                         monotonic_cst=cst, device=d),
        Xp, binary(yp, top), "constrained classifier parity: 50000 rows "
        "depth 10", PARITY_FIELDS + ("value", "impurity"))
    out["classifier"] = dict(
        first_s=f1, second_s=f2, n_nodes=clf.tree_.n_nodes,
        depth=clf.get_depth(), heldout_acc=acc, unconstrained_heldout_acc=
        plain_acc, unconstrained_n_nodes=plain.tree_.n_nodes,
        peak_gib=peak, launches=launches, monotone_anchors=8,
        monotone_grid=GRID, parity_nodes=parity, **clf.fit_stats_)
    log(f"constrained classifier: {len(X)} x {X.shape[1]} (class {top} vs "
        f"rest), monotonic_cst +1 on column 0, -1 on column 5, depth "
        f"{DEPTH}: first {f1:.3f} s, second {f2:.3f} s; n_nodes "
        f"{clf.tree_.n_nodes}; held-out acc {acc:.6f} (unconstrained, "
        f"device engine: {plain_acc:.6f}, {plain.tree_.n_nodes} nodes); "
        f"monotone on both columns (8 anchors x {GRID}); peak "
        f"{peak:.3f} GiB; launches {launches}")

    reg = DecisionTreeRegressor(max_depth=DEPTH, max_bins=256,
                                monotonic_cst=[1] + [0] * (Xc.shape[1] - 1))
    f1, f2, rlaunches, peak = _fit_twice(reg, Xc, yc,
                                         routes=hist_kernel.FIXED_ROUTES)
    r2 = _r2(ych, reg.predict(Xch))
    _monotone(reg, Xc, Xch[:8], 0, 1, "constrained regressor")
    Xp, yp = california_like(50_000, seed=2)
    parity = _constrained_parity(
        lambda d: DecisionTreeRegressor(
            max_depth=10, max_bins=256,
            monotonic_cst=[1] + [0] * (Xc.shape[1] - 1), device=d),
        Xp, yp, "constrained regressor parity: 50000 rows depth 10",
        PARITY_FIELDS + ("value", "impurity", "parent", "depth"))
    out["regressor"] = dict(
        first_s=f1, second_s=f2, n_nodes=reg.tree_.n_nodes,
        depth=reg.get_depth(), heldout_r2=r2, unconstrained_heldout_r2=reg_r2,
        peak_gib=peak, launches=rlaunches, parity_nodes=parity,
        **reg.fit_stats_)
    log(f"constrained regressor: {len(Xc)} x {Xc.shape[1]}, monotonic_cst "
        f"+1 on MedInc, depth {DEPTH}: first {f1:.3f} s, second {f2:.3f} s; "
        f"n_nodes {reg.tree_.n_nodes}; held-out R2 {r2:.6f} (unconstrained, "
        f"phase 13: {reg_r2:.6f}); monotone (8 anchors x {GRID}); peak "
        f"{peak:.3f} GiB; launches {rlaunches}")

    Xf, yf = X[:FOREST_ROWS], yb[:FOREST_ROWS]
    forest = RandomForestClassifier(**FOREST, monotonic_cst=cst)
    for k in hist_kernel.launches:
        hist_kernel.launches[k] = 0
    t0 = time.perf_counter()
    forest.fit(Xf, yf)
    torch.cuda.synchronize()
    fs = time.perf_counter() - t0
    flaunches = dict(hist_kernel.launches)
    if not all(flaunches[k] for k in hist_kernel.ROUTES):
        raise AssertionError(f"constrained forest launches {flaunches}")
    proba = forest.predict_proba(Xh)
    facc = float(np.mean(forest.classes_[proba.argmax(axis=1)] == yhb))
    nodes = int(sum(t.n_nodes for t in forest.trees_))

    for k in serve_kernel.launches:
        serve_kernel.launches[k] = 0
    cm = compile_model(forest)
    cm8 = compile_model(forest, quantize="int8", quantize_tol=1.0)
    if cm.kind != "forest_values" or cm8.kind != "forest_values":
        raise AssertionError(f"constrained forest compiled to {cm.kind}")
    served = {}
    for n in SERVE_SHAPES[:3]:
        t0 = time.perf_counter()
        got = cm.raw(Xh[:n])
        served[n] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, forest.predict_proba(Xh[:n])):
            raise AssertionError(f"served constrained forest != "
                                 f"predict_proba at {n} rows")
        cm8.raw(Xh[:n])
    rep = cm8.serve_report_["quantization"]
    cal = quantize.synthesize_calibration(cm8.table, Xh.shape[1])
    cal_delta = float(np.abs(cm8.raw(cal) - cm.raw(cal)).max())
    slaunches = dict(serve_kernel.launches)
    if not (slaunches["traverse"] and slaunches["traverse_q"]):
        raise AssertionError(f"constrained serving launches {slaunches}")
    if not (rep["ok"] and cal_delta <= rep["max_abs_delta"] + 1e-6):
        raise AssertionError(f"int8 constrained forest outside its report: "
                             f"delta {cal_delta}, report {rep}")
    rows = _served_kernel_rows(cm, cm8, Xh, "forest_values")
    out["forest"] = dict(
        fit_s=fs, heldout_acc=facc, nodes_total=nodes, launches=flaunches,
        served_ms=served, serve_launches=slaunches, kernels=rows,
        quantization=rep, calibration_delta=cal_delta)
    log(f"constrained forest: {len(Xf)} x {Xf.shape[1]}, "
        f"{FOREST['n_estimators']} trees depth {FOREST['max_depth']}: fit "
        f"{fs:.3f} s, {nodes} nodes, held-out acc {facc:.6f}; launches "
        f"{flaunches}; served forest_values == predict_proba at "
        f"{list(served)} rows (host ms {served}); int8 within its report "
        f"(delta {cal_delta:.6g} <= {rep['max_abs_delta']:.6g}); serve "
        f"launches {slaunches}")
    return out, clf, forest


def phase_persistence(forest, clf, Xh) -> dict:
    """Phase 20: ``save_model`` of phase 5's forest and phase 19's
    constrained classifier, ``load_model`` of both: ``predict`` and
    ``predict_proba`` bit for bit as the originals; the loaded forest
    compiled and served equals the original's served answers."""
    from mpitree_tpu_torch import load_model, save_model
    from mpitree_tpu_torch.serving import compile_model

    out_dir = Path("build") / "chip_smoke_models"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, est in (("forest", forest), ("constrained_classifier", clf)):
        path = out_dir / f"{name}.npz"
        t0 = time.perf_counter()
        save_model(est, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_model(path)
        load_s = time.perf_counter() - t0
        for meth in ("predict", "predict_proba"):
            a, b = getattr(back, meth)(Xh), getattr(est, meth)(Xh)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"loaded {name}: {meth} differs")
        out[name] = dict(bytes=path.stat().st_size, save_s=save_s,
                         load_s=load_s)
        if name == "forest":
            Xq = Xh[:SERVE_SHAPES[2]]
            if not np.array_equal(compile_model(back).raw(Xq),
                                  compile_model(est).raw(Xq)):
                raise AssertionError("loaded forest serves other answers")
        log(f"persistence: {name}: {out[name]['bytes']} bytes, save "
            f"{save_s:.3f} s, load {load_s:.3f} s; predict and "
            f"predict_proba bit for bit" + (
                "; served answers equal the original's"
                if name == "forest" else ""))
    return out


def _boosted_fit(cls, X, y, Xh, yh, what: str, kw: dict) -> tuple:
    """One warm-up fit (``max_iter=2``), then the measured fit with the
    histogram counters set to 0 just before it and read just after: the
    fixed-point routes must have launched (``sorted_fixed`` only on the
    host round loop: the fused rounds' leaf-wise trees launch the stream
    route) and the integer routes not."""
    from mpitree_tpu_torch.ops import hist_kernel

    cls(**{**kw, "max_iter": 2}).fit(X, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in hist_kernel.launches:
        hist_kernel.launches[k] = 0
    t0 = time.perf_counter()
    est = cls(**kw).fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _on_card(est, what)
    launches = dict(hist_kernel.launches)
    host_loop = est.fit_stats_["rounds_per_dispatch"]["value"] == 1
    if not (launches["stream_fixed"] and (launches["sorted_fixed"]
                                          or not host_loop)) or (
            launches["stream"] or launches["sorted"]):
        raise AssertionError(f"{what}: histogram launches {launches}")
    t0 = time.perf_counter()
    pred = est.predict(Xh)
    predict_s = time.perf_counter() - t0
    score = (float((pred == yh).mean()) if hasattr(est, "classes_")
             else _r2(yh, pred))
    nodes = sum(t.n_nodes for t in est.trees_)
    if not np.isfinite(est.train_score_).all() or not (
            est.train_score_[-1] > est.train_score_[0]):
        raise AssertionError(f"{what}: training loss did not fall: "
                             f"{est.train_score_[[0, -1]]}")
    out = dict(wall_s=wall, fit_stats=est.fit_stats_, launches=launches,
               trees=len(est.trees_), nodes_total=nodes,
               heldout=score, predict_s=predict_s,
               train_loss=[-float(est.train_score_[0]),
                           -float(est.train_score_[-1])],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               params={k: kw.get(k, v) for k, v in (
                   ("max_iter", 100), ("max_depth", 6),
                   ("learning_rate", 0.1), ("min_samples_leaf", 20),
                   ("max_bins", 256))})
    st = est.fit_stats_
    log(f"boosting {what}: {len(X)} x {X.shape[1]}, {len(est.trees_)} "
        f"trees ({nodes} nodes): fit {wall:.3f} s = bin "
        f"{st['bin_seconds']:.3f} + loss {st['loss_seconds']:.3f} + build "
        f"{st['build_seconds']:.3f} + refit {st['refit_seconds']:.3f}; "
        f"held-out {'accuracy' if hasattr(est, 'classes_') else 'R^2'} "
        f"{score:.6f}; predict {predict_s:.3f} s; launches {launches}; "
        f"peak device memory {out['peak_gib']:.3f} GiB")
    return est, out


def phase_boosting(X, y, Xh, yh, Xc, yc, Xch, ych) -> tuple:
    """Phase 21: ``GradientBoostingClassifier()`` at the JAX package's
    defaults on the full covtype matrix (7 classes: 7 trees a round) and
    ``GradientBoostingRegressor()`` on phase 13's matrix, each after a
    2-round warm-up fit; wall, laps, held-out accuracy / R^2, the
    fixed-point launches of the measured fit, peak device memory."""
    from mpitree_tpu_torch.tree import (
        GradientBoostingClassifier,
        GradientBoostingRegressor,
    )

    kw = dict(max_iter=BOOST_ROUNDS)
    clf, c = _boosted_fit(GradientBoostingClassifier, X, y, Xh, yh,
                          "classifier", kw)
    reg, r = _boosted_fit(GradientBoostingRegressor, Xc, yc, Xch, ych,
                          "regressor", kw)
    return clf, reg, {"classifier": c, "regressor": r}


def _same_ensembles(a, b) -> bool:
    return len(a.trees_) == len(b.trees_) and all(
        _same_fields(s, t, BOOST_FIELDS) for s, t in zip(a.trees_, b.trees_))


def phase_boosting_parity() -> dict:
    """Phase 22: 10 rounds at depth 6 with ``subsample=0.8`` and
    ``colsample_bytree=0.5`` on ``covtype_like(20_000, seed=4)`` (7
    classes, and made binary as phase 19 makes it) and
    ``california_like(20_000, seed=4)``: two fits on the card and one with
    ``device="cpu"``, identical trees and bit-for-bit margins."""
    from mpitree_tpu_torch.tree import (
        GradientBoostingClassifier,
        GradientBoostingRegressor,
    )
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    X, y = covtype_like(20_000, seed=4)
    Xr, yr = california_like(20_000, seed=4)
    out = {}
    for what, cls, Xd, yd in (
            ("multiclass", GradientBoostingClassifier, X, y),
            ("binary", GradientBoostingClassifier, X,
             binary(y, int(np.bincount(y).argmax()))),
            ("regression", GradientBoostingRegressor, Xr, yr)):
        a = cls(**BOOST_PARITY, device="cuda").fit(Xd, yd)
        b = cls(**BOOST_PARITY, device="cuda").fit(Xd, yd)
        t0 = time.perf_counter()
        c = cls(**BOOST_PARITY, device="cpu").fit(Xd, yd)
        cpu_s = time.perf_counter() - t0

        def margins(m):
            return (m.decision_function(Xd) if hasattr(m, "classes_")
                    else m.predict(Xd))

        if not (_same_ensembles(a, b) and _same_ensembles(a, c)):
            raise AssertionError(f"boosting parity {what}: trees differ")
        ma = margins(a)
        if not (np.array_equal(ma, margins(b))
                and np.array_equal(ma, margins(c))):
            raise AssertionError(f"boosting parity {what}: margins differ")
        out[what] = dict(trees=len(a.trees_),
                         nodes=sum(t.n_nodes for t in a.trees_),
                         cpu_fit_s=cpu_s)
        log(f"boosting parity {what}: {len(a.trees_)} trees, "
            f"{out[what]['nodes']} nodes: two card fits and the CPU's "
            f"identical, margins bit for bit (CPU fit {cpu_s:.3f} s)")
    return out


def phase_boosting_serving(clf, reg, Xh, Xch) -> dict:
    """Phase 23: ``compile_model`` of phase 21's classifier and regressor
    (kind ``margin``): K4 ``percls`` from the baseline row equals
    ``decision_function`` / ``predict`` bit for bit at 1, 64 and 4,096
    rows, K5 (``quantize="int8"``) stays within its report on its
    calibration batch; the traversal counters are set to 0 just before
    and both kernels must launch; both kernels alone at 4,096 rows equal
    their plain versions, timed beside their bound. Then
    ``save_model``/``load_model`` of both: answers bit for bit."""
    from mpitree_tpu_torch import load_model, save_model
    from mpitree_tpu_torch.serving import compile_model, quantize, serve_kernel

    out = {}
    for what, est, Xq in (("classifier", clf, Xh), ("regressor", reg, Xch)):
        def answer(m, X):
            return (m.decision_function(X) if what == "classifier"
                    else m.predict(X))

        for k in serve_kernel.launches:
            serve_kernel.launches[k] = 0
        t0 = time.perf_counter()
        cm = compile_model(est)
        # no refusal threshold: one int8 affine over 700 trees' margins
        # refuses at the default tolerance (PERF.md, phase 23); the report
        # says how far the int8 tables are, and K5 is held to it
        cm8 = compile_model(est, quantize="int8", quantize_tol=math.inf)
        compile_s = time.perf_counter() - t0
        served = {}
        for n in SERVE_SHAPES[:3]:
            t0 = time.perf_counter()
            got = answer(cm, Xq[:n])
            served[n] = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(got, answer(est, Xq[:n])):
                raise AssertionError(f"served boosted {what} != estimator "
                                     f"at {n} rows")
            cm8.raw(Xq[:n])
        rep = cm8.serve_report_["quantization"]
        cal = quantize.synthesize_calibration(cm8.table, Xq.shape[1])
        cal_delta = float(np.abs(cm8.raw(cal) - cm.raw(cal)).max())
        launches = dict(serve_kernel.launches)
        if not (launches["traverse"] and launches["traverse_q"]):
            raise AssertionError(f"boosted {what} serving launches "
                                 f"{launches}")
        if not (rep["ok"] and cal_delta <= rep["max_abs_delta"] + 1e-6):
            raise AssertionError(f"int8 boosted {what} outside its report: "
                                 f"delta {cal_delta}, report {rep}")
        rows = _served_kernel_rows(cm, cm8, Xq, f"margin {what}",
                                   agg="percls")
        out_dir = Path("build") / "chip_smoke_models"
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"boosted_{what}.npz"
        t0 = time.perf_counter()
        save_model(est, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_model(path)
        load_s = time.perf_counter() - t0
        meths = (("decision_function", "predict_proba", "predict")
                 if what == "classifier" else ("predict",))
        for meth in meths:
            a, b = getattr(back, meth)(Xq), getattr(est, meth)(Xq)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"loaded boosted {what}: {meth} "
                                     "differs")
        out[what] = dict(trees=cm.table.n_trees, n_out=cm.n_out,
                         compile_s=compile_s, served_ms=served,
                         launches=launches, kernels=rows, quantization=rep,
                         calibration_delta=cal_delta,
                         file=dict(bytes=path.stat().st_size, save_s=save_s,
                                   load_s=load_s))
        log(f"boosted serving {what}: {cm.table.n_trees} trees into "
            f"{cm.n_out} columns, compiled in {compile_s:.3f} s; K4 margins "
            f"== estimator at {list(served)} rows (host ms {served}); int8 "
            f"within its report (delta {cal_delta:.6g} <= "
            f"{rep['max_abs_delta']:.6g}, relative "
            f"{rep['max_rel_delta']:.6g}); launches {launches}; file "
            f"{path.stat().st_size} bytes, save {save_s:.3f} s, load "
            f"{load_s:.3f} s, answers bit for bit")
    return out


def _set_engine(engine: str, subtraction: str) -> None:
    """Steer the ``"auto"`` engine and subtraction of the fits that follow
    (``core/builder.ENGINE_ENV``, ``SUBTRACTION_ENV``)."""
    os.environ["MPITREE_TPU_ENGINE"] = engine
    os.environ["MPITREE_TPU_HIST_SUBTRACTION"] = subtraction


def _d2h_copies(work) -> tuple:
    """``work()`` once under torch.profiler, tracing the card only:
    (device-to-host copies, wall s, device busy share)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e6
    return sum("DtoH" in e.name for e in events), wall, busy / wall


def _frontier_read_cost(X, y, Xc, yc) -> dict:
    """What the fused engine's one read a level costs: phase 3's and phase
    13's builds (``fused_builder._grow``, binning and finalizing left out)
    with the reads, and with the frontier sizes of an earlier build given
    (no synchronisation in the level loop): read, then given. The builds
    must be the same tree."""
    from mpitree_tpu_torch.core import fused_builder
    from mpitree_tpu_torch.core.builder import BuildConfig, FitInputs
    from mpitree_tpu_torch.ops.binning import bin_for_engine

    out = {}
    for what, Xa, ya, cfg, kw in (
            ("tree", X, y, BuildConfig(max_depth=DEPTH), dict(n_classes=7)),
            ("regressor", Xc, (yc - yc.mean()).astype(np.float32),
             BuildConfig(task="regression", criterion="mse",
                         max_depth=DEPTH), {})):
        binned = bin_for_engine(Xa, max_bins=256, binning="auto", device=DEV)
        fit = FitInputs(binned, ya, cfg, **kw)
        ref = fused_builder._grow(fit, cfg, use_sub=False)
        sizes = [s for _, s in ref.levels]
        walls = {"read": [], "given": []}
        for mode in ("read", "given"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = fused_builder._grow(fit, cfg, use_sub=False,
                                    sizes=sizes if mode == "given" else None)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            if not (torch.equal(g.ints, ref.ints)
                    and torch.equal(g.counts, ref.counts)):
                raise AssertionError(f"engines: {what} build with given "
                                     f"frontier sizes differs")
        out[what] = dict(levels=len(sizes), **walls)
        del binned, fit, ref, g
        torch.cuda.empty_cache()
    log(f"engines: fused build with its reads vs with given frontier "
        f"sizes: {json.dumps(out)}")
    return out


def _trees_of(est) -> list:
    return list(est.trees_) if hasattr(est, "trees_") else [est.tree_]


def phase_engines(X, y, Xc, yc, fused: dict) -> dict:
    """Phase 24: phase 3's tree, phase 5's forest (its first
    ``ENGINE_TREES`` trees, which a forest of that size draws alike) and
    phase 13's regressor under each engine (``MPITREE_TPU_ENGINE``) and,
    for the tree, with sibling subtraction on and off in both
    (``MPITREE_TPU_HIST_SUBTRACTION``), once each; phases 3 and 13 ran the
    fused tree and regressor without subtraction (``fused``: their walls,
    launches and trees). Every tree must equal the fused one field for
    field. The fused engine's frontier reads are counted by the engine (at
    most one a level). Then the cost of those reads
    (:func:`_frontier_read_cost`)."""
    from mpitree_tpu_torch.core import fused_builder
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        DecisionTreeRegressor,
        RandomForestClassifier,
    )

    t0 = time.perf_counter()
    Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
    forest_kw = dict(FOREST, n_estimators=ENGINE_TREES, **DEVICE_ONLY)
    work = {
        "tree": (lambda: DecisionTreeClassifier(
            criterion="entropy", max_depth=DEPTH, max_bins=256,
            **DEVICE_ONLY), X, y, ENGINE_RUNS[1:], hist_kernel.ROUTES),
        "forest": (lambda: RandomForestClassifier(**forest_kw), Xf, yf,
                   ENGINE_RUNS[::2], hist_kernel.ROUTES),
        "regressor": (lambda: DecisionTreeRegressor(
            max_depth=DEPTH, max_bins=256, **DEVICE_ONLY), Xc, yc,
            ENGINE_RUNS[2:3], hist_kernel.FIXED_ROUTES),
    }
    out, seconds = {}, {}
    try:
        for what, (make, Xa, ya, runs, routes) in work.items():
            t1 = time.perf_counter()
            ref = fused[what]
            want = ref["trees"][:ENGINE_TREES]
            res = {} if what == "forest" else {"fused/off": dict(
                wall_s=ref["second_s"], launches=ref["launches"],
                source="phases 3, 13")}
            for engine, sub in runs:
                _set_engine(engine, sub)
                est = make()
                reads0 = fused_builder.frontier_reads
                wall, launches = _fit_once(est, Xa, ya, routes=routes)
                got = _trees_of(est)
                if len(got) != len(want) or not all(
                        _same_fields(a, b, PARITY_FIELDS + (
                            "parent", "depth", "value", "impurity"))
                        for a, b in zip(got, want)):
                    raise AssertionError(
                        f"engines: {what} {engine}/{sub} differs from the "
                        f"fused build")
                res[f"{engine}/{sub}"] = dict(
                    wall_s=wall, launches=launches,
                    frontier_reads=fused_builder.frontier_reads - reads0,
                    engine=est.fit_stats_["engine"])
            levels = sum(int(t.depth.max()) + 1 for t in want)
            for key, r in res.items():
                if key.startswith("fused") and r.get(
                        "frontier_reads", 0) > levels:
                    raise AssertionError(
                        f"engines: {what} {key} read the frontier size "
                        f"{r['frontier_reads']} times in {levels} levels")
            res["levels"] = levels
            res["nodes"] = int(sum(t.n_nodes for t in want))
            out[what] = res
            seconds[what] = time.perf_counter() - t1
            log(f"engines: {what}: identical trees in every run; "
                + json.dumps(res))
        t1 = time.perf_counter()
        out["frontier_read_cost"] = _frontier_read_cost(X, y, Xc, yc)
        seconds["frontier_read_cost"] = time.perf_counter() - t1
    finally:
        _set_engine("auto", "auto")
    sub_gain = {k: out["tree"][f"{k}/off"]["wall_s"]
                / out["tree"][f"{k}/on"]["wall_s"]
                for k in ("levelwise", "fused")}
    out["tree_subtraction_speedup"] = sub_gain
    out["seconds"] = dict(seconds, total=time.perf_counter() - t0)
    log(f"engines: tree wall off/on {sub_gain} (>1: subtraction faster); "
        f"phase seconds {json.dumps(out['seconds'])}")
    return out


def _leafwise_build_cost(binned, y, cfg_kw: dict, what: str, modes,
                         n_classes=None) -> dict:
    """The fused leaf-wise build (``leafwise_builder._LeafLoop``,
    binning and finalizing left out) in the turns ``modes``: ``"read"``
    reads its 1-byte ``active`` flag every ``CHECK_EVERY`` expansions,
    ``"fixed"`` runs the fixed trip count of ``P - 1`` expansions (both
    without subtraction), ``"sub"`` reads as ``"read"`` with sibling
    subtraction. Walls per mode, the flag reads, and the same tree in
    every turn."""
    from mpitree_tpu_torch.core import leafwise_builder as lw
    from mpitree_tpu_torch.core.builder import BuildConfig, FitInputs

    cfg = BuildConfig(**cfg_kw)
    fit = FitInputs(binned, y, cfg, n_classes=n_classes)
    pool = lw._pool_capacity(cfg.max_leaf_nodes, cfg.max_depth, fit.N)
    walls = {m: [] for m in modes}
    reads, ref = {}, None
    for mode in modes:
        reads0 = lw.done_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = lw._LeafLoop(fit, cfg, pool=pool, use_sub=mode == "sub").grow(
            None if mode == "fixed" else lw.CHECK_EVERY)
        n_nodes = int(g.n_nodes)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        reads[mode] = lw.done_reads - reads0
        got = (n_nodes, g.ints[:, :n_nodes].cpu(), g.counts[:n_nodes].cpu())
        if ref is None:
            ref = got
        elif not (got[0] == ref[0] and torch.equal(got[1], ref[1])
                  and torch.equal(got[2], ref[2])):
            raise AssertionError(f"leafwise {what}: the builds of "
                                 f"{modes} grew different trees")
    out = dict(pool=pool, expansions=(ref[0] - 1) // 2,
               check_every=lw.CHECK_EVERY, flag_reads=reads.get("read"),
               **walls)
    log(f"leafwise {what}: builds: " + json.dumps(out))
    return out


def phase_leafwise(X, y, Xh, yh, Xc, yc, Xch, ych) -> dict:
    """Phase 25: best-first growth (``max_leaf_nodes``) at covtype's full
    width. (a) ``max_leaf_nodes=4096`` at depth 12 equals the unbudgeted
    depth-12 fused tree field for field, in both leaf-wise engines; its
    build with flag reads against the fixed trip count. (b)
    ``max_leaf_nodes=255`` unbounded in depth, twice with subtraction off
    and on (the counters around the second fit; the same tree); wall,
    expansions, profiled device-to-host copies (off), flag reads,
    held-out accuracy; the build with flag reads, the fixed trip count
    and subtraction in turns. (c) ``DecisionTreeRegressor(
    max_leaf_nodes=255)`` on phase 13's matrix. (d) card vs CPU at 50,000
    rows, budget 255 (phase 4's tie rule). (e) (b)'s tree through
    ``compile_model`` (equal to ``predict_proba``) and its count channel
    through K4 (``sum``), bit for bit."""
    from mpitree_tpu_torch.core import leafwise_builder as lw
    from mpitree_tpu_torch.ops.binning import bin_for_engine
    from mpitree_tpu_torch.serving import compile_model, serve_kernel
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        DecisionTreeRegressor,
    )
    from mpitree_tpu_torch.utils.datasets import covtype_like

    out, seconds = {}, {}
    fields = PARITY_FIELDS + ("parent", "depth", "value", "impurity")
    t0 = time.perf_counter()
    try:
        base = DecisionTreeClassifier(
            max_depth=LEAF_IDENTITY["max_depth"], max_bins=256,
            **DEVICE_ONLY)
        t1 = time.perf_counter()
        depth12 = base.fit(X, y).tree_
        torch.cuda.synchronize()
        ident = dict(nodes=int(depth12.n_nodes),
                     levelwise_fused_s=time.perf_counter() - t1)
        for engine in ("fused", "levelwise"):
            _set_engine(engine, "off")
            reads0 = lw.done_reads
            est = DecisionTreeClassifier(max_bins=256, **LEAF_IDENTITY)
            t1 = time.perf_counter()
            est.fit(X, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            if not _same_fields(est.tree_, depth12, fields):
                raise AssertionError(
                    f"leafwise identity: {engine} engine at budget "
                    f"{LEAF_IDENTITY['max_leaf_nodes']} != the depth-"
                    f"{LEAF_IDENTITY['max_depth']} level-wise tree")
            ident[engine] = dict(wall_s=wall,
                                 expansions=est.fit_stats_["expansions"],
                                 flag_reads=lw.done_reads - reads0,
                                 engine=est.fit_stats_["engine"])
        _set_engine("auto", "off")
        binned = bin_for_engine(X, max_bins=256, binning="auto",
                                device=DEV)
        ident["trip_cost"] = _leafwise_build_cost(
            binned, y, dict(max_depth=LEAF_IDENTITY["max_depth"],
                       max_leaf_nodes=LEAF_IDENTITY["max_leaf_nodes"]),
            "identity build", ("read", "fixed"), n_classes=7)
        out["identity"] = ident
        log(f"leafwise identity: both engines == the depth-"
            f"{LEAF_IDENTITY['max_depth']} tree: " + json.dumps(ident))
        seconds["identity"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        budget = {}
        trees = {}
        for sub in ("off", "on"):
            _set_engine("auto", sub)
            est = DecisionTreeClassifier(max_leaf_nodes=LEAF_BUDGET,
                                         max_bins=256)
            reads0 = lw.done_reads
            f1, f2, launches, peak = _fit_twice(est, X, y,
                                                routes=("stream",))
            reads = (lw.done_reads - reads0) // 2
            trees[sub] = est.tree_
            acc = float(np.mean(est.predict(Xh) == yh))
            budget[sub] = dict(
                first_s=f1, second_s=f2, launches=launches, peak_gib=peak,
                expansions=est.fit_stats_["expansions"],
                leaves=est.get_n_leaves(), depth=est.get_depth(),
                flag_reads=reads, heldout_acc=acc, fit_stats=est.fit_stats_)
            if sub == "off":
                copies, pwall, busy = _d2h_copies(
                    lambda: DecisionTreeClassifier(
                        max_leaf_nodes=LEAF_BUDGET, max_bins=256).fit(X, y))
                budget[sub].update(profiled_d2h_copies=copies,
                                   profiled_wall_s=pwall,
                                   profiled_busy_share=busy)
            # the root and every expansion, masked ones past the end
            # (at most CHECK_EVERY - 1) included
            n_exp = budget[sub]["expansions"]
            if launches["sorted"] or not (
                    n_exp + 1 <= launches["stream"] < n_exp + 1
                    + lw.CHECK_EVERY):
                raise AssertionError(f"leafwise budget {sub}: launches "
                                     f"{launches}")
        _set_engine("auto", "auto")
        if not _same_fields(trees["off"], trees["on"], fields):
            raise AssertionError("leafwise budget: subtraction changed the "
                                 "tree")
        budget["subtraction_speedup"] = (budget["off"]["second_s"]
                                         / budget["on"]["second_s"])
        budget["builds"] = _leafwise_build_cost(
            binned, y, dict(max_leaf_nodes=LEAF_BUDGET),
            f"budget {LEAF_BUDGET}",
            ("read", "fixed", "sub", "sub", "fixed", "read"), n_classes=7)
        out["budget"] = budget
        clf = est
        log(f"leafwise budget {LEAF_BUDGET}: identical with subtraction off "
            f"and on; " + json.dumps(budget))
        seconds["budget"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        reg = DecisionTreeRegressor(max_leaf_nodes=LEAF_BUDGET, max_bins=256)
        f1, f2, launches, peak = _fit_twice(reg, Xc, yc,
                                            routes=("stream_fixed",))
        r2 = _r2(ych, reg.predict(Xch))
        out["regressor"] = dict(
            first_s=f1, second_s=f2, launches=launches, peak_gib=peak,
            heldout_r2=r2, expansions=reg.fit_stats_["expansions"],
            leaves=reg.get_n_leaves())
        log(f"leafwise regressor: " + json.dumps(out["regressor"]))
        seconds["regressor"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        Xp, yp = covtype_like(50_000, seed=2)
        kw = dict(max_leaf_nodes=LEAF_BUDGET, max_bins=256)
        t1 = time.perf_counter()
        gpu = DecisionTreeClassifier(device="cuda", **kw).fit(Xp, yp)
        t2 = time.perf_counter()
        cpu = DecisionTreeClassifier(device="cpu", **kw).fit(Xp, yp)
        t3 = time.perf_counter()
        _check_parity(gpu.tree_, cpu.tree_, Xp, yp, tie_depth=64,
                      what=f"leafwise parity: 50000 rows budget "
                      f"{LEAF_BUDGET}, cuda {t2 - t1:.3f} s, cpu "
                      f"{t3 - t2:.3f} s")
        out["parity"] = dict(nodes=int(gpu.tree_.n_nodes), cuda_s=t2 - t1,
                             cpu_s=t3 - t2)
        seconds["parity"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for k in serve_kernel.launches:
            serve_kernel.launches[k] = 0
        cm = compile_model(clf)
        Xq = Xh[:SERVE_SHAPES[2]]
        want = clf.predict_proba(Xq)
        if not np.array_equal(cm.predict_proba(Xq), want):
            raise AssertionError("leafwise serve: compile_model != "
                                 "predict_proba")
        table = cm.table
        cols = table.dev_arrays(DEV)[:5]
        values = cm._values.to(torch.float64)
        Xd = torch.from_numpy(np.ascontiguousarray(Xq)).to(DEV)
        kw = dict(n_steps=table.n_steps, agg="sum", n_out=7)
        got = serve_kernel.traverse(Xd, *cols, values,
                                    n_features=Xq.shape[1], **kw)
        ref = serve_kernel.traverse_reference(Xd, *cols, values, **kw)
        if not (torch.equal(got, ref) and np.array_equal(
                got.cpu().numpy(), want.astype(np.float64))):
            raise AssertionError("leafwise serve: K4 != predict_proba")
        ms = cuda_ms(lambda: serve_kernel.traverse(
            Xd, *cols, values, n_features=Xq.shape[1], **kw), reps=5,
            inner=SERVE_INNER[SERVE_SHAPES[2]], hold=True)
        out["serve"] = dict(rows=len(Xq), k4_ms=ms, dispatch=cm.dispatch,
                            launches=dict(serve_kernel.launches),
                            nodes=int(clf.tree_.n_nodes))
        log(f"leafwise serve: compile_model ({cm.dispatch}) == predict_proba"
            f" and K4 sum == predict_proba at {len(Xq)} rows, bit for bit; "
            + json.dumps(out["serve"]))
        seconds["serve"] = time.perf_counter() - t0
    finally:
        _set_engine("auto", "auto")
    out["seconds"] = seconds
    return out, trees["off"]


def _margins(est, X, what: str) -> np.ndarray:
    return (est.decision_function(X) if what == "classifier"
            else est.predict(X))


def _boost_divergence(fused, host, X, y, what: str) -> dict:
    """Where a fused-rounds ensemble first leaves the host loop's, and why.

    The fused rounds carry float32 margins, the host loop float64 ones;
    the gradients then differ in their last float32 bits, which moves a
    split only where two candidates' Newton costs lie that close. So the
    trees must be equal up to the first divergent node, both trees must
    split it, and there the two chosen candidates' float64 costs on the
    host loop's own float32 (g, h) of that round (its margins from the
    rounds before) lie within ``NEAR_TIE`` relative; the margins of the
    rounds before it must agree within 2e-4 (the JAX package's bound).
    Returns the round, node, cost gap and margin delta."""
    for t, (a, b) in enumerate(zip(fused.trees_, host.trees_)):
        if _same_fields(a, b, ("feature", "threshold", "left", "right")):
            continue
        n = min(a.n_nodes, b.n_nodes)
        node = next((i for i in range(n) if not (
            a.feature[i] == b.feature[i] and a.left[i] == b.left[i]
            and (a.feature[i] < 0 or a.threshold[i] == b.threshold[i]))),
            n)
        raw_f = raw_h = None
        for i, (rf, rh) in enumerate(zip(fused._staged_raw(X),
                                         host._staged_raw(X))):
            if i + 1 == t:
                raw_f, raw_h = rf[:, 0].copy(), rh[:, 0].copy()
                break
        if raw_h is None:  # the first round: both start at the baseline
            raw_h = np.full(len(X), float(host._baseline_raw[0]))
            raw_f = raw_h
        before = float(np.abs(raw_f - raw_h).max())
        if node >= n or a.feature[node] < 0 or b.feature[node] < 0:
            raise AssertionError(
                f"fused rounds {what}: tree {t} node {node}: one ensemble "
                "splits a node the other leaves")
        g, h = host._loss().grad_hess(raw_h[:, None], y)
        g32 = g[:, 0].astype(np.float32).astype(np.float64)
        h32 = h[:, 0].astype(np.float32).astype(np.float64)
        rows = _node_rows(b, X, node)

        def cost(f, thr):
            left = rows & (X[:, f] <= thr)
            right = rows & ~(X[:, f] <= thr)
            return -0.5 * sum(g32[m].sum() ** 2 / max(h32[m].sum(), 1e-12)
                              for m in (left, right))

        ca = cost(int(a.feature[node]), a.threshold[node])
        cb = cost(int(b.feature[node]), b.threshold[node])
        gap = abs(ca - cb) / max(abs(ca), abs(cb), 1e-300)
        out = dict(tree=t, node=node, depth=int(b.depth[node]),
                   rows=int(rows.sum()), cost_gap=gap,
                   margin_delta_before=before)
        log(f"fused rounds {what}: first divergence " + json.dumps(out))
        if gap > NEAR_TIE or before > 2e-4:
            raise AssertionError(f"fused rounds {what}: divergence beyond "
                                 f"a near tie: {out}")
        return out
    return {}


def phase_fused_rounds(X, y, Xh, yh, Xc, yc, Xch, ych) -> dict:
    """Phase 26: ``GradientBoostingRegressor()`` on phase 13's matrix and
    ``GradientBoostingClassifier(max_leaf_nodes=31)`` on phase 19's binary
    covtype, each at ``rounds_per_dispatch`` 1 (the host loop) and 8 (the
    fused rounds), after a 2-round warm-up: wall, launches, copies per
    dispatch (counted by ``fused_rounds.copies``, and profiled on the
    regressor's one 8-round dispatch), the largest |margin K=8 - margin
    K=1| on held-out rows (within 2e-4, or else
    :func:`_boost_divergence`), held-out R^2 / accuracy. The K=8
    ensembles are served as ``margin`` through K4 (bit for bit) and K5
    (within its report). Returns the record and the regressor's
    ensembles by K."""
    from mpitree_tpu_torch.boosting import fused_rounds
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.serving import compile_model, quantize, serve_kernel
    from mpitree_tpu_torch.tree import (
        GradientBoostingClassifier,
        GradientBoostingRegressor,
    )

    top = int(np.bincount(y).argmax())
    out = {}
    for what, cls, kw, Xd, yd, Xq, yq in (
            ("regressor", GradientBoostingRegressor, {}, Xc, yc, Xch, ych),
            ("classifier", GradientBoostingClassifier,
             dict(max_leaf_nodes=BOOST_LEAVES), X, binary(y, top), Xh,
             binary(yh, top))):
        res, ests = {}, {}
        for K in (1, FUSED_K):
            kk = dict(kw, rounds_per_dispatch=K, max_iter=BOOST_ROUNDS)
            cls(**{**kk, "max_iter": 2}).fit(Xd, yd)
            torch.cuda.synchronize()
            for k in hist_kernel.launches:
                hist_kernel.launches[k] = 0
            copies0 = fused_rounds.copies
            t0 = time.perf_counter()
            est = cls(**kk).fit(Xd, yd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = est.fit_stats_
            if not hist_kernel.launches["stream_fixed"]:
                raise AssertionError(f"fused rounds {what} K={K}: no "
                                     "stream_fixed launch")
            if st["rounds_per_dispatch"]["value"] != K:
                raise AssertionError(f"fused rounds {what}: K {K} not taken:"
                                     f" {st['rounds_per_dispatch']}")
            pred = est.predict(Xq)
            score = (float(np.mean(pred == yq)) if what == "classifier"
                     else _r2(yq, pred))
            res[K] = dict(wall_s=wall, launches=dict(hist_kernel.launches),
                          heldout=score, fit_stats=st,
                          nodes=int(sum(t.n_nodes for t in est.trees_)))
            if K > 1:
                res[K]["copies"] = fused_rounds.copies - copies0
                res[K]["copies_per_dispatch"] = (res[K]["copies"]
                                                 / st["dispatches"])
            ests[K] = est
        delta = float(np.abs(_margins(ests[FUSED_K], Xq, what)
                             - _margins(ests[1], Xq, what)).max())
        if delta > 2e-4:
            # a split moved by the float32 margins: it must be a near tie
            res["divergence"] = _boost_divergence(ests[FUSED_K], ests[1],
                                                  Xd, yd, what)
        if what == "regressor":  # the most copies: its residual read
            copies, pwall, busy = _d2h_copies(lambda: cls(**dict(
                kw, rounds_per_dispatch=FUSED_K, max_iter=FUSED_K)).fit(
                    Xd, yd))
            res["one_dispatch_profiled"] = dict(
                d2h_copies=copies, wall_s=pwall, busy_share=busy)
        res["max_margin_delta"] = delta
        res["speedup_k8"] = res[1]["wall_s"] / res[FUSED_K]["wall_s"]

        est = ests[FUSED_K]
        for k in serve_kernel.launches:
            serve_kernel.launches[k] = 0
        cm = compile_model(est)
        cm8 = compile_model(est, quantize="int8", quantize_tol=math.inf)
        for n in SERVE_SHAPES[:3]:
            if not np.array_equal(_margins(cm, Xq[:n], what),
                                  _margins(est, Xq[:n], what)):
                raise AssertionError(f"fused rounds {what}: served margins "
                                     f"!= estimator at {n} rows")
            cm8.raw(Xq[:n])
        rep = cm8.serve_report_["quantization"]
        cal = quantize.synthesize_calibration(cm8.table, Xq.shape[1])
        cal_delta = float(np.abs(cm8.raw(cal) - cm.raw(cal)).max())
        launches = dict(serve_kernel.launches)
        if not (launches["traverse"] and launches["traverse_q"]):
            raise AssertionError(f"fused rounds {what}: serving launches "
                                 f"{launches}")
        if not (rep["ok"] and cal_delta <= rep["max_abs_delta"] + 1e-6):
            raise AssertionError(f"fused rounds {what}: int8 outside its "
                                 f"report: delta {cal_delta}, report {rep}")
        res["serving"] = dict(
            launches=launches, quantization=rep, calibration_delta=cal_delta,
            kernels=_served_kernel_rows(cm, cm8, Xq, f"fused {what}",
                                        agg="percls"))
        out[what] = res
        if what == "regressor":
            reg_ests = dict(ests)
        log(f"fused rounds {what}: K=1 {res[1]['wall_s']:.3f} s, K="
            f"{FUSED_K} {res[FUSED_K]['wall_s']:.3f} s (x"
            f"{res['speedup_k8']:.3f}); max |margin delta| {delta:.3e}; "
            f"held-out {res[1]['heldout']:.6f} / "
            f"{res[FUSED_K]['heldout']:.6f}; " + json.dumps(
                {k: v for k, v in res.items() if k != "serving"}))
    return out, reg_ests


class _HeldModel:
    """A published model whose ``raw`` waits on a gate: phase 27's burst
    arrives while the scheduler's worker is held in its first dispatch."""

    def __init__(self, model, gate, entered):
        self.model, self.gate, self.entered = model, gate, entered

    def __getattr__(self, name):
        return getattr(self.model, name)

    def raw(self, X):
        self.entered.set()
        if not self.gate.wait(60):
            raise AssertionError("burst: the held dispatch was never freed")
        return self.model.raw(X)


class _HeldRegistry:
    """A ``ModelRegistry`` whose models are :class:`_HeldModel`s."""

    def __init__(self, reg):
        self.reg = reg
        self.gate = threading.Event()
        self.entered = threading.Event()

    def get(self, name):
        return _HeldModel(self.reg.get(name), self.gate, self.entered)

    def metrics_families(self):
        return self.reg.metrics_families()


def _require_launches(what: str, launches: dict) -> dict:
    """``launches`` (a copy of the traversal counters) if both kernels
    launched, else raise."""
    if not all(launches.values()):
        raise AssertionError(f"{what} launched {launches}")
    return launches


def _stage_pass(cm, X, depth: int) -> tuple:
    """``X`` in ``STAGE_BATCH``-row batches through ``StreamStage(cm,
    depth)`` (depth 0: a loop of synchronous ``raw``): (wall s, the
    answers in order)."""
    from mpitree_tpu_torch.serving import StreamStage

    t0 = time.perf_counter()
    if depth == 0:
        outs = [(i, cm.raw(X[lo:lo + STAGE_BATCH]))
                for i, lo in enumerate(range(0, len(X), STAGE_BATCH))]
    else:
        stage = StreamStage(cm, depth=depth)
        outs = []
        for lo in range(0, len(X), STAGE_BATCH):
            outs += stage.submit(X[lo:lo + STAGE_BATCH])
        outs += stage.drain()
    wall = time.perf_counter() - t0
    if [t for t, _ in outs] != list(range(len(outs))):
        raise AssertionError(f"stage depth {depth}: tickets out of order")
    return wall, np.concatenate([o for _, o in outs])


def _copy_overlap(trace_path: Path) -> dict:
    """From a Chrome trace of one depth-2 pass: seconds in which a
    host-to-device copy on a stream other than the traversal kernels'
    overlaps a traversal kernel, beside both totals."""
    events = json.loads(trace_path.read_text())["traceEvents"]

    def spans(pred):
        return sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get(
            "stream")) for e in events if e.get("ph") == "X" and pred(e))

    kernels = spans(lambda e: e.get("cat") == "kernel"
                    and "traverse_kernel" in e.get("name", ""))
    streams = {s for *_, s in kernels}
    copies = spans(lambda e: e.get("cat") == "gpu_memcpy"
                   and "HtoD" in e.get("name", ""))
    side = [c for c in copies if c[2] not in streams]
    overlap, j = 0.0, 0
    for a0, a1, _ in side:  # both lists sorted, each disjoint in itself
        while j < len(kernels) and kernels[j][1] <= a0:
            j += 1
        k = j
        while k < len(kernels) and kernels[k][0] < a1:
            overlap += min(a1, kernels[k][1]) - max(a0, kernels[k][0])
            k += 1
    return dict(overlap_s=overlap / 1e6,
                h2d_copy_stream_s=sum(b - a for a, b, _ in side) / 1e6,
                h2d_copy_stream_copies=len(side),
                h2d_other_copies=len(copies) - len(side),
                traverse_kernel_s=sum(b - a for a, b, _ in kernels) / 1e6,
                traverse_kernels=len(kernels), kernel_streams=sorted(
                    str(s) for s in streams))


def _sched_run(sched, rows: np.ndarray, want: dict, *, n: int, seed: int,
               model: str = "rf", rate: float | None = None,
               window: int = CLOSED_WINDOW, qos: str | None = None) -> dict:
    """``n`` single-row requests to ``model`` from ``SCHED_THREADS``
    submitter threads, ``SCHED_MIX`` of them ``interactive`` and the rest
    ``batch`` (or all ``qos``): closed loop (each thread keeps ``window``
    in flight) or, given ``rate`` (requests/s in all), open loop, each
    request sent at its own time. Each answer and its exact latency are
    stored when its future resolves (so a thread holds only what its loop
    needs); every answer must equal the direct ``raw`` of its row
    (``want[model]``); sheds are counted by reason."""
    from collections import deque

    from mpitree_tpu_torch.serving import RejectedRequest

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(rows), n)
    cls = np.where(rng.random(n) < SCHED_MIX, "interactive", "batch")
    if qos is not None:
        cls[:] = qos
    lat = np.full(n, np.nan)
    got = np.full((n,) + want[model].shape[1:], np.nan)
    sheds: dict = {}
    lock = threading.Lock()
    start = threading.Barrier(SCHED_THREADS + 1)
    last_sent = [0.0] * SCHED_THREADS

    finished = threading.Semaphore(0)

    def done(f, i, sent):
        lat[i] = time.perf_counter() - sent
        got[i] = f.result()
        finished.release()

    def worker(t):
        inflight = deque()
        start.wait()
        t0 = time.perf_counter()
        for k, i in enumerate(range(t, n, SCHED_THREADS)):
            if rate is not None:
                delay = t0 + (k * SCHED_THREADS + t) / rate \
                    - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            elif len(inflight) >= window:
                inflight.popleft().result(timeout=120)
            sent = time.perf_counter()
            try:
                fut = sched.submit(model, rows[idx[i]], qos=str(cls[i]))
            except RejectedRequest as e:
                with lock:
                    sheds[e.reason] = sheds.get(e.reason, 0) + 1
                continue
            fut.add_done_callback(
                lambda f, i=i, sent=sent: done(f, i, sent))
            if rate is None:
                inflight.append(fut)
        last_sent[t] = time.perf_counter()
        while inflight:
            inflight.popleft().result(timeout=120)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(SCHED_THREADS)]
    for th in threads:
        th.start()
    start.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    if any(th.is_alive() for th in threads) or not sched.drain(60):
        raise AssertionError("scheduler run did not finish")
    for _ in range(n - sum(sheds.values())):  # every admitted one resolved
        if not finished.acquire(timeout=120):
            raise AssertionError("scheduler: an admitted request was never "
                                 "answered")
    wall = time.perf_counter() - t0
    st = sched.stats()
    ok = np.isfinite(lat)
    answered = int(ok.sum())
    if answered + sum(sheds.values()) != n or not np.array_equal(
            got[ok], want[model][idx[ok]]):
        raise AssertionError(f"scheduler: {answered} answered and "
                             f"{sheds} shed of {n}, or an answer differs "
                             f"from the direct raw of its row")
    per_class = {}
    for c in ("interactive", "batch"):
        ms = lat[(cls == c) & np.isfinite(lat)] * 1e3
        if ms.size:
            per_class[c] = dict(requests=int(ms.size),
                                p50_ms=float(np.percentile(ms, 50)),
                                p99_ms=float(np.percentile(ms, 99)),
                                max_ms=float(ms.max()))
    if sheds != st["shed"]:
        raise AssertionError(f"sheds seen {sheds} != scheduler's "
                             f"{st['shed']}")
    sent_s = max(last_sent) - t0
    return dict(requests=n, answered=answered, wall_s=wall,
                rate_per_s=answered / wall, offered_per_s=rate,
                sent_s=sent_s, sent_per_s=n / sent_s,
                latency_exact=per_class,
                latency_histogram=st["class_latency_ms"], shed=sheds,
                deadline_misses=st["deadline_misses"],
                dispatches=st["dispatches"], requeues=st["requeues"],
                mean_batch=answered / max(st["dispatches"], 1))


def phase_serve_tier(forest, reg_tree, Xbig, Xh, Xch,
                     profile_dir: Path | None) -> dict:
    """Phase 27: the host-side serving tier. (a) phase 5's forest as
    ``rf`` and ``rf8``; phase 7's 500,000 rows in 4,096-row batches
    through ``StreamStage`` at depths 1, 2 and 4 and a loop of synchronous
    ``raw``, three timed passes each after one warm pass: ``rf`` equal to
    ``forest.predict_proba`` bit for bit, ``rf8`` to its own direct
    ``raw``, and the calibration batch through the stage within the
    report. (b) under ``--profile``, one depth-2 pass traced: the seconds
    in which a host-to-device copy on the copy stream overlaps a
    traversal kernel. (c) ``Scheduler(registry)`` at the default QoS:
    single-row requests, 80% ``interactive``, from 4 submitter threads;
    a closed loop finds the sustained rate, then open loops at 50% and
    90% of it, 20,000 requests each; ``rf8`` in a closed loop; every
    answer equal to its row's direct ``raw``; then 2 x
    ``shed_depth`` ``batch`` submissions at once behind a held first
    dispatch: exactly ``shed_depth`` admitted and answered, the rest shed
    ``queue_full``.
    (d) phase 13's regressor with ``quantize="int8"``: its report, the
    calibration delta within it, the held-out delta, table bytes. The
    reference answers are taken first; the traversal launch counters are
    set to 0 just before each stage pass and each ``raw`` loop (summed
    apart), before the first scheduler run and before (d), and read just
    after, so each path counts only its own launches."""
    import dataclasses

    from mpitree_tpu_torch.serving import (
        ModelRegistry,
        RejectedRequest,
        Scheduler,
        compile_model,
        quantize,
        serve_kernel,
    )
    from mpitree_tpu_torch.serving.tables import tables_for
    from mpitree_tpu_torch.tree import DecisionTreeRegressor

    def zero():
        for k in serve_kernel.launches:
            serve_kernel.launches[k] = 0

    def counted(tally: dict, work, *args):
        """``work(*args)`` with the launch counters set to 0 just before
        it, its launches added to ``tally``."""
        zero()
        res = work(*args)
        for k, v in serve_kernel.launches.items():
            tally[k] = tally.get(k, 0) + v
        return res

    out: dict = {"launches": {}}
    reg = ModelRegistry()
    reg.publish("rf", forest)
    reg.publish("rf8", forest, quantize="int8")
    # the references, before any count is taken
    [table] = tables_for(forest.trees_, group_bytes=None)
    cal = quantize.synthesize_calibration(table, Xbig.shape[1])
    want_big = {"rf": forest.predict_proba(Xbig),
                "rf8": reg.raw("rf8", Xbig)}
    want_cal = reg.raw("rf", cal)

    # (a) the stage
    tally: dict = {"stage": {}, "raw loop": {}}
    stage = {}
    for name in ("rf", "rf8"):
        cm = reg.get(name)
        stage[name] = {}
        for depth in (0, *STAGE_DEPTHS):
            walls = []
            for rep in range(1 + STAGE_REPS):
                wall, got = counted(tally["stage" if depth else "raw loop"],
                                    _stage_pass, cm, Xbig, depth)
                if not np.array_equal(got, want_big[name]):
                    raise AssertionError(
                        f"stage {name} depth {depth}: answers differ (max "
                        f"|diff| {np.abs(got - want_big[name]).max()})")
                if rep:
                    walls.append(wall)
            key = "raw loop" if depth == 0 else f"depth {depth}"
            med = statistics.median(walls)
            stage[name][key] = dict(walls_s=walls, wall_s=med,
                                    rows_per_s=len(Xbig) / med)
        stage[name]["pinned_slots"] = dict(made=cm._slots.allocated,
                                           kept=cm._slots.kept)
    rep8 = reg.get("rf8").serve_report_["quantization"]
    _, cal8 = counted(tally["stage"], _stage_pass, reg.get("rf8"), cal, 2)
    cal_delta = float(np.abs(cal8 - want_cal).max())
    if not (rep8["ok"] and cal_delta <= rep8["max_abs_delta"] + 1e-6):
        raise AssertionError(f"stage rf8 outside its report: delta "
                             f"{cal_delta}, report {rep8}")
    for key, t in tally.items():
        out["launches"][key] = _require_launches(f"serve tier (a) {key}", t)
    out["stage"] = dict(batch_rows=STAGE_BATCH, rows=len(Xbig),
                        calibration_delta_rf8=cal_delta, **stage)
    log(f"serve tier (a) stage, {len(Xbig)} rows in {STAGE_BATCH}-row "
        "batches: " + "; ".join(
        f"{name} " + ", ".join(f"{k} {v['wall_s']:.4f} s = "
                               f"{v['rows_per_s']:.1f} rows/s"
                               for k, v in stage[name].items()
                               if k != "pinned_slots")
        for name in stage) + f"; rf == predict_proba, rf8 == its raw, "
        f"calibration delta {cal_delta} <= report "
        f"{rep8['max_abs_delta']}; launches {out['launches']}")

    # (b) the copy overlap, profiled
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        cm = reg.get("rf")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = _stage_pass(cm, Xbig, 2)
            torch.cuda.synchronize()
        profile_dir.mkdir(parents=True, exist_ok=True)
        path = profile_dir / "trace_serve_tier_depth2.json"
        prof.export_chrome_trace(str(path))
        out["copy_overlap"] = dict(wall_s=wall, **_copy_overlap(path))
        log(f"serve tier (b) depth-2 pass profiled: "
            f"{json.dumps(out['copy_overlap'])}")

    # (c) the scheduler; K4 only from `rf`'s runs, K5 only from `rf8`'s
    want = {name: reg.raw(name, Xh) for name in ("rf", "rf8")}
    zero()
    sched: dict = {}
    with Scheduler(reg) as s:
        _sched_run(s, Xh, want, n=2_000, seed=0)  # warm the path
    with Scheduler(reg) as s:
        sched["closed"] = _sched_run(s, Xh, want, n=SCHED_CLOSED, seed=1)
    rate = sched["closed"]["rate_per_s"]

    def open_loop(share):
        with Scheduler(reg) as s:
            return _sched_run(s, Xh, want, n=SCHED_OPEN, seed=2,
                              rate=share * rate)

    for share in SCHED_LOADS:
        sched[f"open {share}"] = open_loop(share)
    with Scheduler(reg) as s:
        sched["closed rf8"] = _sched_run(s, Xh, want, n=SCHED_CLOSED // 2,
                                         seed=3, model="rf8")
    held = _HeldRegistry(reg)
    with Scheduler(held) as s:
        held.gate.clear()
        first = s.submit("rf", Xh[0], qos="batch")
        if not held.entered.wait(30):
            raise AssertionError("burst: the worker never dispatched")
        futs, sheds = [], {}
        start = threading.Barrier(SCHED_THREADS)
        lock = threading.Lock()
        rows = np.random.default_rng(4).integers(0, len(Xh),
                                                 2 * s.shed_depth)

        def burst_worker(t):
            start.wait()
            for i in range(t, len(rows), SCHED_THREADS):
                try:
                    f = s.submit("rf", Xh[rows[i]], qos="batch")
                    with lock:
                        futs.append((i, f))
                except RejectedRequest as e:
                    with lock:
                        sheds[e.reason] = sheds.get(e.reason, 0) + 1

        threads = [threading.Thread(target=burst_worker, args=(t,))
                   for t in range(SCHED_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        submit_s = time.perf_counter() - t0
        held.gate.set()
        first.result(timeout=60)
        for i, f in futs:
            if not np.array_equal(f.result(timeout=120),
                                  want["rf"][rows[i]]):
                raise AssertionError("burst: an admitted answer differs")
        answered_s = time.perf_counter() - t0
        st = s.stats()
    if not (len(futs) == s.shed_depth
            and sheds == {"queue_full": s.shed_depth} == st["shed"]):
        raise AssertionError(f"burst: admitted {len(futs)}, shed {sheds}, "
                             f"scheduler {st['shed']}")
    sched["burst"] = dict(submitted=len(rows), admitted=len(futs),
                          shed=sheds, submit_s=submit_s,
                          all_answered_s=answered_s,
                          dispatches=st["dispatches"],
                          deadline_misses=st["deadline_misses"])
    out["launches"]["scheduler"] = _require_launches(
        "serve tier (c)", dict(serve_kernel.launches))
    out["scheduler"] = dict(qos=[dataclasses.asdict(c) for c in s.qos],
                            shed_depth=s.shed_depth,
                            margin_ms=s.margin_s * 1e3,
                            wait_ms=s.wait_s * 1e3, **sched)
    for key, r in sched.items():
        log(f"serve tier (c) scheduler {key}: " + json.dumps(r))

    # (d) the quantized regression tree
    zero()
    est = DecisionTreeRegressor.from_reference(
        dataclasses.asdict(reg_tree), Xch.shape[1], device=DEV.type)
    cm = compile_model(est)
    cm8 = compile_model(est, quantize="int8")
    rep = cm8.serve_report_["quantization"]
    cal = quantize.synthesize_calibration(cm8.table, Xch.shape[1])
    cal_delta = float(np.abs(cm8.raw(cal) - cm.raw(cal)).max())
    t0 = time.perf_counter()
    held_out = cm8.raw(Xch)
    q_s = time.perf_counter() - t0
    exact = cm.raw(Xch)
    if not (np.array_equal(exact, est.predict(Xch)) and rep["ok"]
            and cal_delta <= rep["max_abs_delta"] + 1e-6
            and held_out.dtype == np.float32
            and np.isfinite(held_out).all()):
        raise AssertionError(f"quantized regression tree: calibration "
                             f"delta {cal_delta}, report {rep}")
    q = cm8._quant
    int8_bytes = sum(t.numel() * t.element_size() for t in (
        q.feature, q.threshold, q.left, q.right, q.root, q.qvals))
    f64_bytes = sum(t.numel() * t.element_size()
                    for t in (*cm._dev_table, cm._values))
    out["launches"]["quantized_tree"] = dict(serve_kernel.launches)
    out["quantized_tree"] = dict(
        n_nodes=cm8.table.n_nodes, quantization=rep,
        calibration_delta=cal_delta,
        heldout_max_delta=float(np.abs(held_out - exact).max()),
        heldout_rows=len(Xch), heldout_s=q_s, table_bytes_int8=int8_bytes,
        table_bytes_float64=f64_bytes, dispatch=cm8.dispatch)
    log(f"serve tier (d) quantized regression tree: "
        + json.dumps(out["quantized_tree"]))
    return out


def _differing(tree, want) -> list:
    """The ``TREE_FIELDS`` in which ``tree`` (a TreeArrays or a dict of
    arrays) and ``want`` differ: dtype, shape or any value (NaN
    thresholds equal)."""
    out = []
    for k in TREE_FIELDS:
        a = tree[k] if isinstance(tree, dict) else getattr(tree, k)
        b = getattr(want, k)
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a, b, equal_nan=a.dtype.kind == "f"):
            out.append(k)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


MESH_STATS = ("n_shards", "allreduce_calls", "allreduce_bytes",
              "allreduce_seconds", "replication_checks")


def _mesh_fit_kw(what: str) -> dict:
    """Phase 28's estimator parameters: phase 3's device-engine fit
    (``"tree"``, at ``MESH_DEPTH`` in the two-process run) or phase 8's
    default one (``"default"``)."""
    if what == "default":
        return dict(criterion="entropy", max_depth=DEPTH, max_bins=256)
    return dict(criterion="entropy", max_depth=DEPTH, max_bins=256,
                **DEVICE_ONLY)


def mesh_worker(rank: int, port: int, what: str, out: str) -> int:
    """One process of phase 28 (b) or (d), or of phase 30 (f)
    (``what="stream"``: this process's half of the ``.npy`` shards in
    ``CHIP_SMOKE_SHARDS``, streamed): join the gloo group of
    ``MESH_RANKS`` processes at ``localhost:port``, fit phase 3's matrix
    on ``cuda:0`` with ``n_devices="all"`` (this process's shard of the
    rows), and write the tree (``out.npz``) and the fit's wall, stats and
    launches (``out.json``). Loads the kernels phase 1 built; a missing
    library raises instead of building."""
    from mpitree_tpu_torch import _build, native
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.parallel import distributed
    from mpitree_tpu_torch.tree import ParallelDecisionTreeClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    built = [_build._library_path(n) for n in ("histogram", "traverse")]
    built.append(native.library_path())
    missing = [str(p) for p in built if not p.exists()]
    if missing:
        raise RuntimeError(f"mesh worker: phase 1's libraries are missing "
                           f"({missing}); it does not build them")
    distributed.initialize(f"localhost:{port}", MESH_RANKS, rank,
                           backend="gloo", timeout=MESH_WORKER_TIMEOUT)
    try:
        kw = _mesh_fit_kw(what)
        if what == "stream":
            # phase 30 (f): this process streams only its half of the shards
            from mpitree_tpu_torch.ingest import (
                StreamedDataset,
                shard_for_process,
            )

            shards = Path(os.environ["CHIP_SMOKE_SHARDS"])
            data = StreamedDataset.from_npy(
                shard_for_process(sorted(map(str, shards.glob("x*.npy")))),
                shard_for_process(sorted(map(str, shards.glob("y*.npy")))),
                chunk_rows=STREAM_CHUNK)
        else:
            data = covtype_like(ROWS, seed=0)
        if what in ("tree", "stream"):
            kw["max_depth"] = MESH_DEPTH
        clf = ParallelDecisionTreeClassifier(**kw)
        for k in hist_kernel.launches:
            hist_kernel.launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "stream":
            clf.fit(data)
        else:
            clf.fit(*data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hist_kernel.launches)
        np.savez(out + ".npz",
                 **{k: getattr(clf.tree_, k) for k in TREE_FIELDS})
        st = clf.fit_stats_
        Path(out + ".json").write_text(json.dumps(dict(
            rank=rank, wall_s=wall, launches=launches,
            shard_rows=-(-ROWS // st["n_shards"]),
            **{k: st[k] for k in MESH_STATS + (
                "bin_seconds", "crown_seconds") if k in st},
            **{k: st[k] for k in ("crown_depth", "tail_seconds",
                                  "refine_nodes_added") if k in st},
            **({"ingest": clf.ingest_stats_} if what == "stream" else {}))))
    finally:
        distributed.shutdown()
    return 0


def _mesh_pair(what: str, want, env: dict | None = None) -> dict:
    """Phase 28 (b) or (d): ``MESH_RANKS`` worker processes
    (:func:`mesh_worker`) on this card; every rank's tree must equal
    ``want``. Returns the processes' wall (start to last exit) and each
    rank's record. Every worker is stopped before this returns."""
    out_dir = Path("build") / "chip_smoke_mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    env = dict(os.environ, MPITREE_TPU_DEBUG="1", GLOO_SOCKET_IFNAME="lo",
               **(env or {}))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(r), str(port), what, str(out_dir / f"{what}{r}")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(MESH_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MESH_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh ({what}) rank {r} failed (exit "
                                 f"{p.returncode}):\n{text[-4000:]}")
    ranks = []
    for r in range(MESH_RANKS):
        with np.load(out_dir / f"{what}{r}.npz") as z:
            bad = _differing({k: z[k] for k in TREE_FIELDS}, want)
        if bad:
            raise AssertionError(f"mesh ({what}) rank {r}: tree differs "
                                 f"in {bad}")
        rec = json.loads((out_dir / f"{what}{r}.json").read_text())
        if rec["replication_checks"] == 0 or rec["allreduce_calls"] == 0 \
                or not all(rec["launches"][k] for k in ("stream",
                                                        "sorted")):
            raise AssertionError(f"mesh ({what}) rank {r} did not reduce, "
                                 f"check or launch: {rec}")
        ranks.append(rec)
    return dict(processes_wall_s=wall, ranks=ranks)


def phase_mesh(X, y, Xh, yh, fit_tree, hybrid_tree) -> dict:
    """Phase 28: (b) and (d) in worker pairs, then (a), (e) and (c) in
    this process (the NCCL group last; left before returning)."""
    import copy

    from mpitree_tpu_torch.parallel import distributed
    from mpitree_tpu_torch.tree import ParallelDecisionTreeClassifier

    want_b = fit_tree
    if MESH_DEPTH != DEPTH:  # the cut run's one-process twin
        from mpitree_tpu_torch.tree import DecisionTreeClassifier

        want_b = DecisionTreeClassifier(**dict(
            _mesh_fit_kw("tree"), max_depth=MESH_DEPTH)).fit(X, y).tree_
    out = {"b": _mesh_pair("tree", want_b),
           "d": _mesh_pair("default", hybrid_tree)}
    out["b"]["depth"] = MESH_DEPTH

    def in_process(what: str):
        par = ParallelDecisionTreeClassifier(**_mesh_fit_kw("tree"))
        wall, launches = _fit_once(par, X, y)
        bad = _differing(par.tree_, fit_tree)
        if bad:
            raise AssertionError(f"mesh ({what}): tree differs from phase "
                                 f"3's in {bad}")
        st = par.fit_stats_
        if st["n_shards"] != torch.cuda.device_count():
            raise AssertionError(f"mesh ({what}): {st['n_shards']} shards")
        return par, dict(wall_s=wall, launches=launches,
                         **{k: st[k] for k in MESH_STATS})

    par, out["a"] = in_process("a")
    one = copy.copy(par)
    one.n_devices = None
    one.tree_ = fit_tree
    preds = {}
    for name, est in (("sharded", par), ("one_device", one)):
        t0 = time.perf_counter()
        preds[name] = (est.predict_proba(X), est.predict(Xh))
        preds[name + "_s"] = time.perf_counter() - t0
    if not (np.array_equal(preds["sharded"][0], preds["one_device"][0])
            and np.array_equal(preds["sharded"][1],
                               preds["one_device"][1])):
        raise AssertionError("mesh (e): sharded predict differs")
    out["e"] = dict(rows=len(X) + len(Xh), sharded_s=preds["sharded_s"],
                    one_device_s=preds["one_device_s"])
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                           backend="nccl", timeout=300)
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        _, out["c"] = in_process("c")
    finally:
        distributed.shutdown()
    if backend != "nccl" or out["c"]["allreduce_calls"] == 0:
        raise AssertionError(f"mesh (c): {backend} group, {out['c']}")
    b = out["b"]["ranks"]
    log(f"mesh: (a) one process, {out['a']['n_shards']} shard: "
        f"{out['a']['wall_s']:.3f} s, launches {out['a']['launches']}; (b) "
        f"{MESH_RANKS} gloo processes on one card (invariance, not "
        f"scaling: host-staged), depth {MESH_DEPTH}: processes "
        f"{out['b']['processes_wall_s']:.3f} s, fits "
        f"{[round(r['wall_s'], 3) for r in b]} s, all-reduce "
        f"{b[0]['allreduce_calls']} calls, {b[0]['allreduce_bytes']} "
        f"bytes, {[round(r['allreduce_seconds'], 3) for r in b]} s, "
        f"{b[0]['replication_checks']} replication checks, launches "
        f"{[r['launches'] for r in b]}; (c) NCCL, world 1: "
        f"{out['c']['wall_s']:.3f} s, {out['c']['allreduce_calls']} "
        f"all-reduces; (d) defaults in {MESH_RANKS} processes: "
        f"{out['d']['processes_wall_s']:.3f} s, fits "
        f"{[round(r['wall_s'], 3) for r in out['d']['ranks']]} s; (e) "
        f"sharded predict of {out['e']['rows']} rows "
        f"{out['e']['sharded_s']:.3f} s, one device "
        f"{out['e']['one_device_s']:.3f} s; every tree equal to phase "
        f"3's (phase 8's for (d))")
    return out


# Phase 29's fits in the two worker processes: (part, estimator class,
# parameters, data); "cov" is phase 3's matrix, "cov200k" phase 5's rows,
# "cal" phase 13's. Nothing is cut: each is the configuration of the
# one-process fit it must equal.
ENSEMBLE_FITS = (
    ("a", "RandomForestClassifier", dict(FOREST, **DEVICE_ONLY,
                                         n_devices=MESH_RANKS), "cov200k"),
    ("b", "RandomForestClassifier", dict(FOREST, **DEVICE_ONLY,
                                         n_estimators=2,
                                         n_devices=MESH_RANKS), "cov200k"),
    ("c1", "GradientBoostingRegressor",
     dict(rounds_per_dispatch=1, max_iter=BOOST_ROUNDS,
          n_devices=MESH_RANKS), "cal"),
    ("c8", "GradientBoostingRegressor",
     dict(rounds_per_dispatch=FUSED_K, max_iter=BOOST_ROUNDS,
          n_devices=MESH_RANKS), "cal"),
    ("d", "DecisionTreeClassifier",
     dict(max_leaf_nodes=LEAF_BUDGET, max_bins=256, n_devices=MESH_RANKS),
     "cov"),
    ("e", "DecisionTreeClassifier",
     dict(_mesh_fit_kw("tree"), n_devices=(1, MESH_RANKS)), "cov"),
    ("e_sub", "DecisionTreeClassifier",
     dict(_mesh_fit_kw("tree"), n_devices=(1, MESH_RANKS)), "cov"),
    ("e_gbdt", "GradientBoostingRegressor",
     dict(rounds_per_dispatch=1, max_iter=BOOST_ROUNDS,
          n_devices=(1, MESH_RANKS)), "cal"),
)
# (b)'s (tree, data) shape: a one-byte budget trades the tree axis for
# rows, as tests/test_forest_mesh.py's test_hbm_guard_forces_data_axis
ENSEMBLE_ENV = {"b": {"MPITREE_TPU_FOREST_HBM_BUDGET": "1"},
                "e_sub": {"MPITREE_TPU_HIST_SUBTRACTION": "on"}}
ENSEMBLE_TIMEOUT = 900


def ensembles_worker(rank: int, port: int, out: str) -> int:
    """One process of phase 29: join the gloo group of ``MESH_RANKS``
    processes, then every fit of :data:`ENSEMBLE_FITS` in turn on
    ``cuda:0``, each with the launch counters set to 0 just before it and
    read just after; each model is saved (``save_model``) to
    ``out<part>.npz`` and the walls, launches and ``fit_stats_`` go to
    ``out.json``. Loads the kernels phase 1 built."""
    import mpitree_tpu_torch.tree as T
    from mpitree_tpu_torch import _build, native
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.parallel import distributed
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like
    from mpitree_tpu_torch.utils.serialize import save_model

    built = [_build._library_path(n) for n in ("histogram", "traverse")]
    built.append(native.library_path())
    missing = [str(p) for p in built if not p.exists()]
    if missing:
        raise RuntimeError(f"ensembles worker: phase 1's libraries are "
                           f"missing ({missing}); it does not build them")
    distributed.initialize(f"localhost:{port}", MESH_RANKS, rank,
                           backend="gloo", timeout=ENSEMBLE_TIMEOUT)
    try:
        X, y = covtype_like(ROWS, seed=0)
        Xc, yc = california_like(CAL_ROWS, seed=0)
        data = {"cov": (X, y), "cov200k": (X[:FOREST_ROWS], y[:FOREST_ROWS]),
                "cal": (Xc, yc)}
        recs = {}
        for part, cls, kw, what in ENSEMBLE_FITS:
            env = ENSEMBLE_ENV.get(part, {})
            os.environ.update(env)
            try:
                est = getattr(T, cls)(**kw)
                for k in hist_kernel.launches:
                    hist_kernel.launches[k] = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                est.fit(*data[what])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(hist_kernel.launches)
                peak = torch.cuda.max_memory_allocated()
            finally:
                for k in env:
                    os.environ.pop(k)
            save_model(est, f"{out}{part}.npz")
            st = est.fit_stats_
            recs[part] = dict(
                wall_s=wall, launches=launches, peak_bytes=peak,
                **{k: v for k, v in st.items()
                   if isinstance(v, (int, float, str, list))
                   and not isinstance(v, bool) or k == "graph"})
            log(f"rank {rank} ({part}): {wall:.3f} s")
        Path(out + ".json").write_text(json.dumps(dict(rank=rank, **recs)))
    finally:
        distributed.shutdown()
    return 0


def _ensemble_launches(ens: dict, route: str) -> dict:
    """A route's launches in each part of phase 29, per rank."""
    return {part: [r["launches"][route] for r in ens["ranks"][part]]
            for part in ens["ranks"]}


def _same_trees(got: list, want: list) -> list:
    """The (tree, fields) where two tree lists differ (their lengths
    too)."""
    if len(got) != len(want):
        return [("n_trees", len(got), len(want))]
    return [(i, bad) for i, (a, b) in enumerate(zip(got, want))
            if (bad := _differing(a, b))]


def phase_mesh_ensembles(X, y, Xh, Xc, yc, Xch, forest, fit_tree,
                         leaf_tree, boost_regs) -> dict:
    """Phase 29: one pair of gloo processes on ``cuda:0`` fits every part
    of :data:`ENSEMBLE_FITS` (``ensembles_worker``); every model of both
    ranks must equal its one-process twin field for field: (a) phase 5's
    forest on the (2, 1) tree mesh; (b) a 2-tree forest on the (1, 2)
    (tree, data) mesh, the one-process 2-tree forest fitted here; (c)
    phase 26's regressor ensembles at K = 1 and 8 (trees and held-out
    margins bit for bit); (d) phase 25 (b)'s tree; (e) phase 3's tree on
    the (1, 2) (data, feature) mesh, with subtraction off and on, and the
    K = 1 ensemble on it. (f) rank 0's (a) forest served through K4
    (float64) and K5 (int8) equal to phase 5's forest served alike, bit
    for bit. Two processes on one card: invariance, not scaling."""
    from mpitree_tpu_torch.serving import compile_model, serve_kernel
    from mpitree_tpu_torch.tree import RandomForestClassifier
    from mpitree_tpu_torch.utils.serialize import load_model

    Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
    want_b = RandomForestClassifier(**dict(FOREST, **DEVICE_ONLY,
                                           n_estimators=2)).fit(Xf, yf)
    out_dir = Path("build") / "chip_smoke_mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    env = dict(os.environ, MPITREE_TPU_DEBUG="1", GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(r), str(port), "ensembles", str(out_dir / f"ens{r}_")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(MESH_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=ENSEMBLE_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"mesh ensembles rank {r} failed (exit "
                                 f"{p.returncode}):\n{text[-4000:]}")
    wants = {"a": list(forest.trees_), "b": list(want_b.trees_),
             "c1": list(boost_regs[1].trees_),
             "c8": list(boost_regs[FUSED_K].trees_), "d": [leaf_tree],
             "e": [fit_tree], "e_sub": [fit_tree],
             "e_gbdt": list(boost_regs[1].trees_)}
    margins = {"c1": 1, "c8": FUSED_K, "e_gbdt": 1}
    ranks, models = {}, {}
    for r in range(MESH_RANKS):
        rec = json.loads((out_dir / f"ens{r}_.json").read_text())
        for part, _, _, _ in ENSEMBLE_FITS:
            est = load_model(out_dir / f"ens{r}_{part}.npz", device="cuda")
            est.n_devices = None  # this process holds one shard of one card
            got = (list(est.trees_) if hasattr(est, "trees_")
                   else [est.tree_])
            bad = _same_trees(got, wants[part])
            if bad:
                raise AssertionError(f"mesh ensembles ({part}) rank {r}: "
                                     f"differs from its one-process twin "
                                     f"in {bad[:3]}")
            if part in margins and not np.array_equal(
                    est.predict(Xch), boost_regs[margins[part]].predict(
                        Xch)):
                raise AssertionError(f"mesh ensembles ({part}) rank {r}: "
                                     "margins differ")
            st = rec[part]
            if not any(st["launches"].values()):
                raise AssertionError(f"mesh ensembles ({part}) rank {r}: "
                                     f"no histogram launch: {st}")
            ranks.setdefault(part, []).append(st)
            models.setdefault(part, est)
    # what each part must have moved: the tree exchange, the (1, 2) data
    # reductions, the feature axis's winner gathers and row routes
    for part, keys in (("a", ("tree_exchange_calls",)),
                       ("b", ("allreduce_calls", "tree_exchange_calls")),
                       ("c1", ("allreduce_calls",)),
                       ("c8", ("allreduce_calls",)),
                       ("d", ("allreduce_calls",)),
                       ("e", ("gather_calls", "route_calls")),
                       ("e_gbdt", ("gather_calls", "route_calls"))):
        for st in ranks[part]:
            if not all(st.get(k, 0) > 0 for k in keys):
                raise AssertionError(f"mesh ensembles ({part}): {keys} "
                                     f"not all counted: {st}")
    if [st["forest_mesh"] for st in ranks["a"]] != [[2, 1]] * MESH_RANKS \
            or [st["forest_mesh"] for st in ranks["b"]] != [[1, 2]] * \
            MESH_RANKS:
        raise AssertionError("mesh ensembles: forest meshes "
                             f"{ranks['a'][0]['forest_mesh']}, "
                             f"{ranks['b'][0]['forest_mesh']}")
    # phase 5's answers first; the counts then cover the mesh forest alone
    launches = {}
    for form, kw in (("traverse", {}), ("traverse_q",
                                        dict(quantize="int8"))):
        want = compile_model(forest, **kw).raw(Xh)
        served = compile_model(models["a"], **kw)
        chunks = -(-len(Xh) // served._bucket(len(Xh)))
        for k in serve_kernel.launches:
            serve_kernel.launches[k] = 0
        got = served.raw(Xh)
        counts = dict(serve_kernel.launches)
        if not np.array_equal(got, want):
            raise AssertionError(f"mesh ensembles (f): the mesh forest "
                                 f"served by {form} differs from phase 5's")
        if counts[form] != chunks or sum(counts.values()) != chunks:
            raise AssertionError(f"mesh ensembles (f): {form} launches "
                                 f"{counts}, want {chunks} ({len(Xh)} rows)")
        launches[form] = counts[form]
    out = dict(processes_wall_s=wall, ranks=ranks,
               f=dict(rows=len(Xh), launches=launches))
    log("mesh ensembles (two gloo processes on one card: invariance, not "
        f"scaling): processes {wall:.3f} s; " + "; ".join(
            f"({part}) {[round(st['wall_s'], 3) for st in sts]} s, "
            + ", ".join(f"{k} {sts[0][k]}" for k in (
                "forest_mesh", "allreduce_calls", "allreduce_bytes",
                "gather_calls", "gather_bytes", "route_calls",
                "route_bytes", "tree_exchange_calls",
                "tree_exchange_bytes", "graph") if k in sts[0])
            for part, sts in ranks.items())
        + "; every model equal to its one-process twin in both ranks; "
        f"(f) served K4/K5 bit for bit: {launches}")
    return out


def _rss_growth(work) -> tuple:
    """``work()``'s result and the growth of this process's resident set
    over it: its peak (sampled every 2 ms by a thread) less the set
    before."""
    from mpitree_tpu_torch.obs.memory import host_rss_bytes

    base = host_rss_bytes()
    peak = [base]
    done = threading.Event()

    def sample():
        while not done.wait(0.002):
            peak[0] = max(peak[0], host_rss_bytes())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        out = work()
    finally:
        done.set()
        t.join()
    return out, max(peak[0], host_rss_bytes()) - base


def _write_shards(X, y, where: Path) -> tuple:
    """X and y as ``STREAM_SHARDS`` ``.npy`` shards each, cut so that each
    of ``MESH_RANKS`` processes' contiguous share holds exactly its half of
    the rows (phase 30 (f)'s row blocks)."""
    xs, ys = [], []
    per = STREAM_SHARDS // MESH_RANKS
    for r, idx in enumerate(np.array_split(np.arange(len(X)), MESH_RANKS)):
        for j, part in enumerate(np.array_split(idx, per)):
            i = r * per + j
            xs.append(str(where / f"x{i:02d}.npy"))
            ys.append(str(where / f"y{i:02d}.npy"))
            np.save(xs[-1], X[part[0]:part[-1] + 1])
            np.save(ys[-1], y[part[0]:part[-1] + 1])
    return xs, ys


def phase_stream(X, y, Xh, fit_tree, fit_launches, hybrid_tree, Xc, yc, Xch,
                 boost_reg8) -> dict:
    """Phase 30: the streaming ingest on the card, (a) to (f) of the
    module docstring."""
    import tempfile

    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.serving import compile_model, serve_kernel
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        GradientBoostingRegressor,
        RandomForestClassifier,
        StreamedDataset,
    )

    def zero():
        for c in (hist_kernel.launches, serve_kernel.launches):
            for k in c:
                c[k] = 0
        torch.cuda.synchronize()

    def same(tree, want, what):
        bad = _differing(tree, want)
        if bad:
            raise AssertionError(f"stream ({what}): tree differs in {bad}")

    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream-") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        xs, ys = _write_shards(X, y, tmp)
        out["write_shards_s"] = time.perf_counter() - t0

        def shards():
            return StreamedDataset.from_npy(xs, ys, chunk_rows=STREAM_CHUNK)

        # (a) phase 3's fit, streamed, twice
        clf = DecisionTreeClassifier(criterion="entropy", max_depth=DEPTH,
                                     max_bins=256, **DEVICE_ONLY)
        t0 = time.perf_counter()
        clf.fit(shards())
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        same(clf.tree_, fit_tree, "a, first fit")
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        _, rss = _rss_growth(lambda: clf.fit(shards()))
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        launches = dict(hist_kernel.launches)
        same(clf.tree_, fit_tree, "a")
        if launches != fit_launches:
            raise AssertionError(f"stream (a): launches {launches}, phase "
                                 f"3's {fit_launches}")
        raw_mb = X.nbytes / 1e6
        out["a"] = dict(first_s=first, second_s=second, launches=launches,
                        ingest=clf.ingest_stats_, fit_stats=clf.fit_stats_,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                        host_rss_growth_mb=rss / 1e6, raw_matrix_mb=raw_mb)
        log(f"stream (a): phase 3's fit from {len(xs)} .npy shards, chunks "
            f"of {STREAM_CHUNK}: first {first:.3f} s, second {second:.3f} s "
            f"(ingest: sketch {clf.ingest_stats_['sketch_s']} s, bin+place "
            f"{clf.ingest_stats_['bin_place_s']} s, "
            f"{clf.ingest_stats_['rows_per_s_host']} rows/s on the host); "
            f"tree == phase 3's; launches {launches} == phase 3's; peak "
            f"device memory {out['a']['peak_gib']:.3f} GiB; host RSS growth "
            f"{rss / 1e6:.1f} MB against the {raw_mb:.1f} MB raw matrix; "
            f"ingest_stats_ {json.dumps(clf.ingest_stats_)}")

        # (b) the default fit, streamed: the tail replays the shards
        dflt = DecisionTreeClassifier(criterion="entropy", max_depth=DEPTH,
                                      max_bins=256)
        zero()
        t0 = time.perf_counter()
        dflt.fit(shards())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = dict(dflt.fit_stats_)
        same(dflt.tree_, hybrid_tree, "b")
        if not (st.get("crown_depth") == HYBRID_CROWN
                and st.get("refine_nodes_added", 0) > 0):
            raise AssertionError(f"stream (b): the tail did not engage: {st}")
        out["b"] = dict(wall_s=wall, launches=dict(hist_kernel.launches),
                        fit_stats=st, ingest=dflt.ingest_stats_)
        log(f"stream (b): default fit streamed {wall:.3f} s (crown "
            f"{st['crown_seconds']:.3f} s, tail {st['tail_seconds']:.3f} s, "
            f"{st['refine_nodes_added']} nodes added); tree == phase 8's")

        # (c) phase 5's forest, streamed, and its keyed in-memory twin
        Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
        kw = dict(FOREST, **DEVICE_ONLY)
        zero()
        t0 = time.perf_counter()
        forest = RandomForestClassifier(**kw).fit(
            StreamedDataset.from_arrays(Xf, yf, chunk_rows=STREAM_CHUNK))
        torch.cuda.synchronize()
        forest_s = time.perf_counter() - t0
        forest_launches = dict(hist_kernel.launches)
        os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"] = "1"
        try:
            t0 = time.perf_counter()
            twin = RandomForestClassifier(**kw).fit(Xf, yf)
            torch.cuda.synchronize()
            twin_s = time.perf_counter() - t0
        finally:
            del os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"]
        for i, (a, b) in enumerate(zip(forest.trees_, twin.trees_)):
            same(a, b, f"c, tree {i}")
        if len(forest.trees_) != FOREST["n_estimators"] or not all(
                forest_launches[k] for k in hist_kernel.ROUTES):
            raise AssertionError(f"stream (c): {len(forest.trees_)} trees, "
                                 f"launches {forest_launches}")
        Xq = Xh[:4_096]
        served = {}
        for quant in (None, "int8"):
            cm_twin = compile_model(twin, quantize=quant)
            cm = compile_model(forest, quantize=quant)
            want = cm_twin.raw(Xq)
            zero()
            got = cm.raw(Xq)
            torch.cuda.synchronize()
            served[quant or "float64"] = dict(serve_kernel.launches)
            if not np.array_equal(got, want):
                raise AssertionError(f"stream (c): served {quant} answers "
                                     "differ from the twin's")
        serve_launches = {"traverse": served["float64"]["traverse"],
                          "traverse_q": served["int8"]["traverse_q"]}
        if not all(serve_launches.values()):
            raise AssertionError(f"stream (c): serving launches {served}")
        out["c"] = dict(wall_s=forest_s, twin_wall_s=twin_s,
                        launches=forest_launches,
                        serve_launches=serve_launches,
                        ingest=forest.ingest_stats_)
        log(f"stream (c): phase 5's forest streamed {forest_s:.3f} s, keyed "
            f"in-memory twin {twin_s:.3f} s: {len(forest.trees_)} trees "
            f"equal; launches {forest_launches}; served through K4/K5 bit "
            f"for bit to the twin's on {len(Xq)} rows, launches "
            f"{serve_launches}")

        # (d) phase 26's K = 8 regressor, streamed
        zero()
        t0 = time.perf_counter()
        breg = GradientBoostingRegressor(
            rounds_per_dispatch=FUSED_K, max_iter=BOOST_ROUNDS).fit(
            StreamedDataset.from_arrays(Xc, yc, chunk_rows=STREAM_CHUNK))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if breg.fit_stats_["rounds_per_dispatch"]["value"] != FUSED_K:
            raise AssertionError("stream (d): K not taken")
        if not np.array_equal(breg.predict(Xch), boost_reg8.predict(Xch)):
            raise AssertionError("stream (d): margins differ from phase "
                                 "26's K = 8 ensemble")
        out["d"] = dict(wall_s=wall, launches=dict(hist_kernel.launches),
                        ingest=breg.ingest_stats_)
        log(f"stream (d): GradientBoostingRegressor K={FUSED_K} streamed "
            f"{wall:.3f} s; held-out margins == phase 26's bit for bit; "
            f"launches {out['d']['launches']}")

        # (e) a one-shot generator through the spill rung
        Xs, ys_ = X[:SPILL_ROWS], y[:SPILL_ROWS]

        def gen():
            for lo in range(0, SPILL_ROWS, 8_192):
                yield Xs[lo:lo + 8_192], ys_[lo:lo + 8_192]

        spill_dir = tmp / "spill"
        spill_dir.mkdir()
        os.environ["MPITREE_TPU_SPILL_DIR"] = str(spill_dir)
        try:
            one = DecisionTreeClassifier(criterion="entropy",
                                         max_depth=DEPTH, max_bins=256,
                                         **DEVICE_ONLY).fit(
                StreamedDataset.from_chunks(gen()))
        finally:
            del os.environ["MPITREE_TPU_SPILL_DIR"]
        ref = DecisionTreeClassifier(criterion="entropy", max_depth=DEPTH,
                                     max_bins=256, **DEVICE_ONLY).fit(
            StreamedDataset.from_arrays(Xs, ys_, chunk_rows=8_192))
        same(one.tree_, ref.tree_, "e")
        out["e"] = dict(spill_bytes=one.ingest_stats_["spill_bytes"],
                        spill_chunks=one.ingest_stats_["spill_chunks"])
        log(f"stream (e): one-shot generator of {SPILL_ROWS} rows spilled "
            f"{out['e']['spill_bytes']} bytes in {out['e']['spill_chunks']} "
            "chunks; tree == from_arrays's")

        # (f) two gloo processes, each streaming its half of the shards
        out["f"] = _mesh_pair("stream", fit_tree,
                              env={"CHIP_SMOKE_SHARDS": str(tmp)})
        for r in out["f"]["ranks"]:
            if r["ingest"]["rows_local"] != ROWS // MESH_RANKS:
                raise AssertionError(f"stream (f): rank {r['rank']} "
                                     f"streamed {r['ingest']}")
        log(f"stream (f): {MESH_RANKS} gloo processes on one card, each "
            f"streaming {ROWS // MESH_RANKS} rows: processes "
            f"{out['f']['processes_wall_s']:.3f} s, fits "
            f"{[round(r['wall_s'], 3) for r in out['f']['ranks']]} s; both "
            f"trees == phase 3's; launches "
            f"{[r['launches'] for r in out['f']['ranks']]}")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# Phase 31: resilience on the card. (c)'s and (d)'s fit is phase 4's
# (covtype_like(50_000, seed=2), depth 10, the device engine alone); (i)
# is phase 29 (b)'s 2-tree forest on phase 3's matrix, streamed by two
# processes; the rest reuse earlier phases' models.
RESILIENCE_FIT = dict(criterion="entropy", max_depth=10, max_bins=256,
                      **DEVICE_ONLY)
RESILIENCE_ROWS, RESILIENCE_SEED = 50_000, 2
LEVEL_FAULT = 12  # (b)'s faulted level
KILL_GROUP = 2    # (e): the forest is killed after its second group
KILL_ROUND = 40   # (f): the K = 8 regressor is killed at round 40
SERVE_ROWS = 4_096
SCHED_ROWS = 64
WORKER_TIMEOUT = 300
RUNG_KEYS = ("device_retries", "level_retries", "device_failovers")


def _rungs(st: dict) -> dict:
    return {k: st.get(k, 0) for k in RUNG_KEYS}


def _libraries_built(what: str) -> None:
    """A worker process loads the kernels phase 1 built; it never builds
    them."""
    from mpitree_tpu_torch import _build, native

    built = [_build._library_path(n) for n in ("histogram", "traverse")]
    built.append(native.library_path())
    missing = [str(p) for p in built if not p.exists()]
    if missing:
        raise RuntimeError(f"{what}: phase 1's libraries are missing "
                           f"({missing}); it does not build them")


def sticky_worker(out: str) -> int:
    """Phase 31 (d), in a process of its own: phase 4's fit on the card,
    whose device build first launches a kernel that reads 4 TiB past a
    buffer (Triton), a real illegal memory access that kills the
    process's CUDA context. The ladder must class the error terminal and,
    with ``MPITREE_TPU_ELASTIC=1`` (set by the parent), finish the fit on
    the host tier with no further CUDA call (any would
    raise on the dead context, and none is caught there), so the fit
    completing proves it; then ``torch.cuda.synchronize()`` must still
    raise (the error was sticky). Writes the tree (``out.npz``) and the
    record (``out.json``), then exits 0."""
    import triton
    import triton.language as tl

    from mpitree_tpu_torch.models import classifier as clf_mod
    from mpitree_tpu_torch.resilience import failure
    from mpitree_tpu_torch.tree import DecisionTreeClassifier
    from mpitree_tpu_torch.utils.datasets import covtype_like

    _libraries_built("sticky worker")

    @triton.jit
    def read_far(src, dst, far):
        offs = tl.arange(0, 128).to(tl.int64)
        tl.store(dst + offs, tl.load(src + far + offs))

    X, y = covtype_like(RESILIENCE_ROWS, seed=RESILIENCE_SEED)
    seen = []
    real_build = clf_mod.build_tree

    def faulting(*a, **k):
        buf = torch.zeros(128, dtype=torch.float32, device=DEV)
        read_far[(1,)](buf, buf, 1 << 40)
        try:
            return real_build(*a, **k)
        except Exception as e:
            seen.append(e)
            raise

    clf_mod.build_tree = faulting
    t0 = time.perf_counter()
    clf = DecisionTreeClassifier(**RESILIENCE_FIT).fit(X, y)
    wall = time.perf_counter() - t0
    try:
        torch.cuda.synchronize()
        sticky = False
    except Exception:  # noqa: BLE001 — the dead context's error, expected
        sticky = True
    e = seen[0] if seen else None
    np.savez(out + ".npz", **{k: getattr(clf.tree_, k) for k in TREE_FIELDS})
    Path(out + ".json").write_text(json.dumps(dict(
        wall_s=wall, sticky=sticky,
        error=None if e is None else
        f"{type(e).__name__}: {str(e).splitlines()[0][:200]}",
        error_type=None if e is None else type(e).__name__,
        device_failure=e is not None and failure.is_device_failure(e),
        transient=e is not None and failure.is_transient_failure(e),
        oom=e is not None and failure.is_oom_failure(e),
        rungs=_rungs(clf.fit_stats_), engine=clf.fit_stats_["engine"])))
    print(f"sticky worker: {wall:.3f} s; error {e!r:.200}", flush=True)
    return 0


def stream_forest_worker(rank: int, port: int, out: str) -> int:
    """One process of phase 31 (i): join the gloo group of ``MESH_RANKS``
    processes, stream this process's half of the ``.npy`` shards in
    ``CHIP_SMOKE_SHARDS`` and fit phase 29 (b)'s 2-tree forest on the
    (1, 2) ``(tree, data)`` mesh (``MPITREE_TPU_FOREST_HBM_BUDGET=1``, set
    by the parent), with the launch counters and the peak memory reset
    just before; save the model (``out.npz``) and the record
    (``out.json``)."""
    from mpitree_tpu_torch.ingest import StreamedDataset, shard_for_process
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.parallel import distributed
    from mpitree_tpu_torch.tree import RandomForestClassifier
    from mpitree_tpu_torch.utils.serialize import save_model

    _libraries_built("stream forest worker")
    distributed.initialize(f"localhost:{port}", MESH_RANKS, rank,
                           backend="gloo", timeout=MESH_WORKER_TIMEOUT)
    try:
        shards = Path(os.environ["CHIP_SMOKE_SHARDS"])
        data = StreamedDataset.from_npy(
            shard_for_process(sorted(map(str, shards.glob("x*.npy")))),
            shard_for_process(sorted(map(str, shards.glob("y*.npy")))),
            chunk_rows=STREAM_CHUNK)
        est = RandomForestClassifier(**dict(FOREST, **DEVICE_ONLY,
                                            n_estimators=2,
                                            n_devices=MESH_RANKS))
        for k in hist_kernel.launches:
            hist_kernel.launches[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        est.fit(dataset=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = est.fit_stats_
        save_model(est, out + ".npz")
        Path(out + ".json").write_text(json.dumps(dict(
            rank=rank, wall_s=wall, launches=dict(hist_kernel.launches),
            peak_bytes=torch.cuda.max_memory_allocated(),
            rows_local=est.ingest_stats_["rows_local"],
            **{k: st[k] for k in ("forest_mesh", "exchange_calls",
                                  "exchange_bytes", "exchange_seconds",
                                  "tree_exchange_calls",
                                  "tree_exchange_bytes", "allreduce_calls")
               if k in st})))
    finally:
        distributed.shutdown()
    return 0


def _worker_pair(what: str, out_stem: str, env: dict) -> tuple:
    """``MESH_RANKS`` ``--mesh-worker R PORT what OUT`` processes; every
    one is stopped before this returns. Returns (wall, logs) or raises
    with a failed rank's output."""
    port = _free_port()
    env = dict(os.environ, MPITREE_TPU_DEBUG="1", GLOO_SOCKET_IFNAME="lo",
               **env)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         str(r), str(port), what, f"{out_stem}{r}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(MESH_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{what} rank {r} failed (exit "
                                 f"{p.returncode}):\n{text[-4000:]}")
    return time.perf_counter() - t0, logs


def phase_resilience(X, y, Xh, fit_tree, forest, Xc, yc, Xch, boost_reg8,
                     ens_b_peaks: list) -> dict:
    """Phase 31: resilience on the card, (a) to (i) of the module
    docstring. Every part resets the launch counters just before it and
    reads them just after; a part catches only the ``ChaosKilled`` of its
    own plan and checks that it fired."""
    import tempfile

    from mpitree_tpu_torch.models import classifier as clf_mod
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.resilience import chaos, failure
    from mpitree_tpu_torch.serving import (
        ModelRegistry,
        Scheduler,
        compile_model,
        serve_kernel,
    )
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        GradientBoostingRegressor,
        RandomForestClassifier,
    )
    from mpitree_tpu_torch.utils.datasets import covtype_like
    from mpitree_tpu_torch.utils.serialize import load_model

    def zero():
        for c in (hist_kernel.launches, serve_kernel.launches):
            for k in c:
                c[k] = 0
        torch.cuda.synchronize()

    def launches():
        return {k: v for c in (hist_kernel.launches, serve_kernel.launches)
                for k, v in c.items()}

    def same(tree, want, what):
        bad = _differing(tree, want)
        if bad:
            raise AssertionError(f"resilience ({what}): tree differs in "
                                 f"{bad}")

    def same_forest(got, want, what):
        if len(got) != len(want):
            raise AssertionError(f"resilience ({what}): {len(got)} trees, "
                                 f"want {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, f"{what}, tree {i}")

    def killed(plan, fit, site, what):
        """``fit()`` must die of this plan's kill at ``site``."""
        try:
            fit()
        except chaos.ChaosKilled:
            if not any(f[0] == site and f[2] == "kill" for f in plan.fired):
                raise
        else:
            raise AssertionError(f"resilience ({what}): the kill never "
                                 "fired")
        chaos.clear()

    out = {}
    t_phase = time.perf_counter()
    tree_kw = dict(criterion="entropy", max_depth=DEPTH, max_bins=256,
                   **DEVICE_ONLY)

    # (a) a transient fault at the first dispatch, through the env plan
    zero()
    os.environ["MPITREE_TPU_CHAOS"] = "dispatch:1:unavailable"
    try:
        t0 = time.perf_counter()
        clf = DecisionTreeClassifier(**tree_kw).fit(X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["MPITREE_TPU_CHAOS"]
        chaos.clear()
    same(clf.tree_, fit_tree, "a")
    st = clf.fit_stats_
    if _rungs(st) != dict(device_retries=1, level_retries=0,
                          device_failovers=0) or st["engine"] != "fused":
        raise AssertionError(f"resilience (a): rungs {_rungs(st)}, engine "
                             f"{st['engine']}")
    out["a"] = dict(wall_s=wall, rungs=_rungs(st), launches=launches())
    log(f"resilience (a): dispatch:1:unavailable (DistNetworkError): "
        f"{wall:.3f} s, rungs {_rungs(st)}; tree == phase 3's; launches "
        f"{out['a']['launches']}")

    # (b) the levelwise engine, a transient fault at level 12
    zero()
    os.environ["MPITREE_TPU_ENGINE"] = "levelwise"
    plan = chaos.install([chaos.Fault("level", 1, "unavailable",
                                      at_level=LEVEL_FAULT)])
    try:
        t0 = time.perf_counter()
        clf = DecisionTreeClassifier(**tree_kw).fit(X, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["MPITREE_TPU_ENGINE"]
        chaos.clear()
    same(clf.tree_, fit_tree, "b")
    st = clf.fit_stats_
    levels = int(fit_tree.max_depth) + 1
    if (_rungs(st) != dict(device_retries=0, level_retries=1,
                           device_failovers=0)
            or st["level_dispatches"] != levels + 1
            or plan.fired != [("level", LEVEL_FAULT + 1, "unavailable")]):
        raise AssertionError(f"resilience (b): rungs {_rungs(st)}, levels "
                             f"{st['level_dispatches']} (want {levels} + "
                             f"1), fired {plan.fired}")
    out["b"] = dict(wall_s=wall, rungs=_rungs(st), levels=levels,
                    level_dispatches=st["level_dispatches"],
                    launches=launches())
    log(f"resilience (b): levelwise, level:1:unavailable:at_level="
        f"{LEVEL_FAULT}: {wall:.3f} s, rungs {_rungs(st)}; "
        f"{st['level_dispatches']} level dispatches for {levels} levels "
        f"(levels >= {LEVEL_FAULT} once more, none before); tree == phase "
        f"3's; launches {out['b']['launches']}")

    # (c) a real OOM: the caching allocator capped below phase 4's build
    Xp, yp = covtype_like(RESILIENCE_ROWS, seed=RESILIENCE_SEED)
    card = DecisionTreeClassifier(**RESILIENCE_FIT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    card.fit(Xp, yp)
    torch.cuda.synchronize()
    _on_card(card, "resilience (c), the uncapped fit")
    fit_peak = torch.cuda.max_memory_reserved() - base
    from mpitree_tpu_torch.ops.binning import bin_for_engine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    binned = bin_for_engine(Xp, max_bins=256, binning="auto", device=DEV)
    torch.cuda.synchronize()
    bin_peak = torch.cuda.max_memory_reserved() - base
    del binned
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = base + (bin_peak + fit_peak) // 2
    seen = []  # each failed build's error, classed (no card tensor kept)
    real_build = clf_mod.build_tree

    def watched(*a, **k):
        try:
            return real_build(*a, **k)
        except Exception as e:
            seen.append(dict(
                oom_type=isinstance(e, torch.OutOfMemoryError),
                oom=failure.is_oom_failure(e),
                transient=failure.is_transient_failure(e),
                text=f"{type(e).__name__}: {str(e)[:160]}"))
            raise

    zero()
    clf_mod.build_tree = watched
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        # the port's default: the classified error reaches the caller
        try:
            DecisionTreeClassifier(**RESILIENCE_FIT).fit(Xp, yp)
            raised = None
        except torch.OutOfMemoryError as e:
            raised = type(e).__name__
        gc.collect()  # the failed fit's frames, before the next one
        torch.cuda.empty_cache()
        # asked for: the host rung
        os.environ["MPITREE_TPU_ELASTIC"] = "1"
        with warnings.catch_warnings():
            warnings.filterwarnings("default", message=HOST_RUNG_WARNING)
            t0 = time.perf_counter()
            oom = DecisionTreeClassifier(**RESILIENCE_FIT).fit(Xp, yp)
            wall = time.perf_counter() - t0
    finally:
        del os.environ["MPITREE_TPU_ELASTIC"]
        torch.cuda.set_per_process_memory_fraction(1.0)
        clf_mod.build_tree = real_build
        torch.cuda.empty_cache()
    st = oom.fit_stats_
    if not (raised == "OutOfMemoryError" and len(seen) == 2
            and all(r["oom_type"] and r["oom"] and not r["transient"]
                    for r in seen)
            and _rungs(st) == dict(device_retries=0, level_retries=0,
                                   device_failovers=1)
            and st["engine"] == "host"):
        raise AssertionError(f"resilience (c): default raised {raised}, "
                             f"errors {seen}, rungs {_rungs(st)}, engine "
                             f"{st['engine']}")
    same(oom.tree_, card.tree_, "c, host rung vs the card")
    again = DecisionTreeClassifier(**RESILIENCE_FIT).fit(Xp, yp)
    same(again.tree_, card.tree_, "c, the card after the cap")
    _on_card(again, "resilience (c), the card after the cap")
    out["c"] = dict(wall_s=wall, rungs=_rungs(st), cap_bytes=cap - base,
                    bin_peak_bytes=bin_peak, fit_peak_bytes=fit_peak,
                    default_raised=raised, error=seen[1]["text"],
                    launches=launches())
    log(f"resilience (c): allocator capped at {(cap - base) / 2**20:.1f} "
        f"MiB over the live {base / 2**20:.1f} MiB (binning peak "
        f"{bin_peak / 2**20:.1f}, fit peak {fit_peak / 2**20:.1f}): "
        f"OutOfMemoryError classed OOM, terminal: raised to the caller "
        f"by default; with MPITREE_TPU_ELASTIC=1 the host rung "
        f"{wall:.3f} s, rungs {_rungs(st)}; tree == the card's; the "
        f"uncapped card fits again, the same tree")

    # (d) a real sticky error, in a process of its own
    stem = str(Path("build") / "chip_smoke_sticky")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-worker",
         "0", "0", "sticky", stem], capture_output=True, text=True,
        timeout=WORKER_TIMEOUT,
        env=dict(os.environ, MPITREE_TPU_ELASTIC="1"))
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"resilience (d): the child exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    rec = json.loads(Path(stem + ".json").read_text())
    if not (rec["sticky"] and rec["device_failure"]
            and not rec["transient"] and rec["engine"] == "host"
            and rec["rungs"] == dict(device_retries=0, level_retries=0,
                                     device_failovers=1)):
        raise AssertionError(f"resilience (d): {rec}")
    with np.load(stem + ".npz") as z:
        bad = _differing({k: z[k] for k in TREE_FIELDS}, card.tree_)
    if bad:
        raise AssertionError(f"resilience (d): tree differs in {bad}")
    out["d"] = dict(child_s=child_s, **rec)
    log(f"resilience (d): child process {child_s:.3f} s: {rec['error']} "
        f"classed terminal; host rung fit {rec['wall_s']:.3f} s with no "
        f"further CUDA call (the context stayed dead: "
        f"synchronize raised), rungs {rec['rungs']}; exit 0, tree == the "
        f"card's")

    # (e) config 5's forest checkpointed, killed after its second group
    Xf, yf = X[:FOREST_ROWS], y[:FOREST_ROWS]
    Xq = Xh[:SERVE_ROWS]
    served = compile_model(forest).raw(Xq)  # the reference, not counted
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt-") as tmp:
        path = str(Path(tmp) / "forest.ckpt")
        zero()
        plan = chaos.install([chaos.Fault("dispatch", KILL_GROUP + 1,
                                          "kill")])
        t0 = time.perf_counter()
        killed(plan, lambda: RandomForestClassifier(
            **FOREST, **DEVICE_ONLY, checkpoint=path).fit(Xf, yf),
            "dispatch", "e")
        killed_s = time.perf_counter() - t0
        files = sorted(Path(tmp).iterdir())
        manifest = json.loads(Path(path).read_text())
        ck_bytes = sum(f.stat().st_size for f in files)
        t0 = time.perf_counter()
        resumed = RandomForestClassifier(**FOREST, **DEVICE_ONLY,
                                         checkpoint=path).fit(Xf, yf)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        left = list(Path(tmp).iterdir())
    if manifest["n_items"] != 8 * KILL_GROUP or left:
        raise AssertionError(f"resilience (e): {manifest['n_items']} trees "
                             f"flushed, files left {left}")
    same_forest(resumed.trees_, forest.trees_, "e")
    if not np.array_equal(compile_model(resumed).raw(Xq), served):
        raise AssertionError("resilience (e): served answers differ")
    out["e"] = dict(killed_s=killed_s, resumed_s=resumed_s,
                    flushed_trees=manifest["n_items"],
                    shards=len(manifest["shards"]), files=len(files),
                    checkpoint_bytes=ck_bytes, launches=launches())
    log(f"resilience (e): forest killed after {KILL_GROUP} groups "
        f"({killed_s:.3f} s; {manifest['n_items']} trees in "
        f"{len(manifest['shards'])} shards, {ck_bytes} bytes on disk), "
        f"resumed {resumed_s:.3f} s: 50 trees == phase 5's, served through "
        f"K4 bit for bit; launches {out['e']['launches']}")

    # (f) phase 26's K = 8 regressor checkpointed, killed at round 40
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt-") as tmp:
        path = str(Path(tmp) / "gbdt.ckpt")
        kw = dict(rounds_per_dispatch=FUSED_K, max_iter=BOOST_ROUNDS,
                  checkpoint=path)
        zero()
        plan = chaos.install([chaos.Fault(
            "fused_rounds", KILL_ROUND // FUSED_K + 1, "kill")])
        t0 = time.perf_counter()
        killed(plan, lambda: GradientBoostingRegressor(**kw).fit(Xc, yc),
               "fused_rounds", "f")
        killed_s = time.perf_counter() - t0
        flushed = json.loads(Path(path).read_text())["n_items"]
        t0 = time.perf_counter()
        reg = GradientBoostingRegressor(**kw).fit(Xc, yc)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    st = reg.fit_stats_
    if flushed != KILL_ROUND or st.get("resumed_rounds") != KILL_ROUND:
        raise AssertionError(f"resilience (f): flushed {flushed}, resumed "
                             f"{st.get('resumed_rounds')}")
    if not np.array_equal(reg.predict(Xch), boost_reg8.predict(Xch)):
        raise AssertionError("resilience (f): margins differ from phase "
                             "26's K = 8 ensemble")
    same_forest(reg.trees_, boost_reg8.trees_, "f")
    out["f"] = dict(killed_s=killed_s, resumed_s=resumed_s,
                    flushed_rounds=flushed, dispatches=st["dispatches"],
                    launches=launches())
    log(f"resilience (f): K={FUSED_K} regressor killed at round "
        f"{KILL_ROUND} ({killed_s:.3f} s, {flushed} rounds flushed), "
        f"resumed {resumed_s:.3f} s ({st['dispatches']} dispatches): "
        f"held-out margins == phase 26's bit for bit")

    # (g) a serving blip on phase 7's rf
    cm = compile_model(forest)
    want = cm.raw(Xq)
    zero()
    chaos.install("serving_dispatch:1:unavailable")
    try:
        got = cm.raw(Xq)
    finally:
        chaos.clear()
    retries = cm.metrics.counter("mpitree_serving_retries_total").value
    if not (np.array_equal(got, want) and retries == 1
            and "mpitree_serving_retries_total 1" in cm.metrics_text()):
        raise AssertionError(f"resilience (g): retries {retries}")
    out["g"] = dict(retries_total=retries, launches=launches())
    log(f"resilience (g): serving_dispatch:1:unavailable on rf: "
        f"{len(Xq)} rows bit for bit, mpitree_serving_retries_total "
        f"{retries}; launches {out['g']['launches']}")

    # (h) a scheduler blip requeues once
    reg_s = ModelRegistry()
    reg_s.publish("rf", forest)
    want = reg_s.raw("rf", Xq[:SCHED_ROWS])
    zero()
    chaos.install("sched_dispatch:1:unavailable")
    try:
        with Scheduler(reg_s, qos="q:30000:256", shed_depth=256,
                       margin_ms=5, wait_ms=2) as s:
            futs = [s.submit("rf", Xq[i]) for i in range(SCHED_ROWS)]
            got = np.stack([f.result(timeout=60) for f in futs])
            sst = s.stats()
    finally:
        chaos.clear()
    out["h"] = dict(requeues=sst["requeues"], dispatches=sst["dispatches"],
                    launches=launches())
    if not (np.array_equal(got, want) and 1 <= sst["requeues"] <= SCHED_ROWS):
        raise AssertionError(f"resilience (h): {sst}")
    log(f"resilience (h): sched_dispatch:1:unavailable: {SCHED_ROWS} "
        f"requests, {sst['requeues']} requeued once, every answer == a "
        f"direct raw")

    # (i) F7: the streamed 2-tree forest on the (1, 2) mesh, two processes
    twin_env = os.environ.get("MPITREE_TPU_KEYED_BOOTSTRAP")
    os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"] = "1"
    try:
        twin = RandomForestClassifier(**dict(FOREST, **DEVICE_ONLY,
                                             n_estimators=2)).fit(X, y)
    finally:
        if twin_env is None:
            del os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"]
        else:
            os.environ["MPITREE_TPU_KEYED_BOOTSTRAP"] = twin_env
    out_dir = Path("build") / "chip_smoke_mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream-") as tmp:
        _write_shards(X, y, Path(tmp))
        wall, _ = _worker_pair(
            "stream_forest", str(out_dir / "sf"),
            {"CHIP_SMOKE_SHARDS": tmp,
             "MPITREE_TPU_FOREST_HBM_BUDGET": "1"})
    ranks = []
    for r in range(MESH_RANKS):
        rec = json.loads((out_dir / f"sf{r}.json").read_text())
        est = load_model(str(out_dir / f"sf{r}.npz"))
        same_forest(est.trees_, twin.trees_, f"i, rank {r}")
        if not (rec["forest_mesh"] == [1, MESH_RANKS]
                and rec["exchange_bytes"] == 0
                and rec["rows_local"] == ROWS // MESH_RANKS
                and all(rec["launches"][k] for k in ("stream", "sorted"))):
            raise AssertionError(f"resilience (i): rank {r}: {rec}")
        ranks.append(rec)
    matrix = ROWS * X.shape[1] * 4
    out["i"] = dict(processes_wall_s=wall, ranks=ranks,
                    matrix_bytes=matrix,
                    phase29b_peak_bytes=ens_b_peaks)
    log(f"resilience (i): {MESH_RANKS} gloo processes stream their halves "
        f"into the (1, {MESH_RANKS}) forest: processes {wall:.3f} s; "
        + "; ".join(
            f"rank {r['rank']}: exchange_bytes {r['exchange_bytes']}, peak "
            f"{r['peak_bytes'] / 2**20:.1f} MiB, fit {r['wall_s']:.3f} s"
            for r in ranks)
        + f" (the whole int32 matrix: {matrix / 2**20:.1f} MiB; phase 29 "
        f"(b)'s in-memory 200,000-row fit peaked at "
        f"{[round(p / 2**20, 1) for p in ens_b_peaks]} MiB); 2 trees == "
        "the in-memory keyed twin's in both ranks")
    out["phase_s"] = time.perf_counter() - t_phase
    log("resilience rungs: " + json.dumps(
        {k: v["rungs"] for k, v in out.items()
         if isinstance(v, dict) and "rungs" in v}))
    return out


def phase_profile(name: str, work, out_dir: Path) -> None:
    """Run ``work()`` once more under torch.profiler: device time by kernel
    and the device's busy share of the wall-clock; the table goes to
    ``out_dir/profile_<name>.txt``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in events)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(table)
    by_name: dict = {}
    by_kind: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        kind = next((k for k, keys in PROFILE_KINDS if any(
            s in e.name for s in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile {name}: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall if wall else None,
        "device_kernels": len(events),
        "hist_launches": sum("hist_tile_kernel" in e.name for e in events),
        "d2h_copies": sum("DtoH" in e.name for e in events),
        "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
        "top_device_ms": {k[:90]: v / 1e3 for k, v in top},
    }))


def profile_all(X, y, forest, Xh, out_dir: Path) -> None:
    """``--profile``: one more depth-20 fit and forest fit (device engine
    alone), one more default (hybrid) depth-20 fit, one device-engine
    regression fit (phase 13's) and weighted fit (phase 15's), five rounds
    of phase 21's classifier, and 300 one-row requests to each of a
    freshly published ``rf`` and ``rf8``, each profiled."""
    from mpitree_tpu_torch.serving import ModelRegistry
    from mpitree_tpu_torch.tree import (
        DecisionTreeClassifier,
        DecisionTreeRegressor,
        GradientBoostingClassifier,
        RandomForestClassifier,
    )
    from mpitree_tpu_torch.utils.datasets import california_like

    phase_profile("fit", lambda: DecisionTreeClassifier(
        criterion="entropy", max_depth=DEPTH, max_bins=256,
        **DEVICE_ONLY).fit(X, y), out_dir)
    phase_profile("forest", lambda: RandomForestClassifier(
        **FOREST, **DEVICE_ONLY).fit(X[:FOREST_ROWS], y[:FOREST_ROWS]),
        out_dir)
    phase_profile("hybrid_fit", lambda: DecisionTreeClassifier(
        criterion="entropy", max_depth=DEPTH, max_bins=256).fit(X, y),
        out_dir)
    Xc, yc = california_like(CAL_ROWS, seed=0)
    phase_profile("regression_fit", lambda: DecisionTreeRegressor(
        max_depth=DEPTH, max_bins=256, **DEVICE_ONLY).fit(Xc, yc), out_dir)
    phase_profile("weighted_fit", lambda: DecisionTreeClassifier(
        criterion="entropy", max_depth=DEPTH, max_bins=256,
        **DEVICE_ONLY).fit(X, y, sample_weight=weights(len(y))), out_dir)
    phase_profile("boosting_rounds", lambda: GradientBoostingClassifier(
        max_iter=5).fit(X, y), out_dir)
    reg = ModelRegistry()
    reg.publish("rf", forest)
    reg.publish("rf8", forest, quantize="int8")

    for name in ("rf", "rf8"):
        def requests(name=name):
            for i in range(REQUESTS[0][1]):
                reg.predict_proba(name, Xh[i:i + 1])

        phase_profile(f"serve_b1_{name}", requests, out_dir)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", type=Path,
                    help="profile one more tree fit, forest fit and 300 "
                    "one-row requests to rf and to rf8, and trace one "
                    "depth-2 stage pass; tables and the trace go to DIR")
    ap.add_argument("--mesh-worker", nargs=4,
                    metavar=("RANK", "PORT", "WHAT", "OUT"),
                    help=argparse.SUPPRESS)  # phases 28-29's workers
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if args.mesh_worker:
        rank, port, what, out = args.mesh_worker
        if what == "ensembles":
            return ensembles_worker(int(rank), int(port), out)
        if what == "sticky":
            return sticky_worker(out)
        if what == "stream_forest":
            return stream_forest_worker(int(rank), int(port), out)
        return mesh_worker(int(rank), int(port), what, out)
    import mpitree_tpu_torch  # noqa: F401  (fails outside a checkout)
    from mpitree_tpu_torch.core.builder import BuildConfig, _chunk_size
    from mpitree_tpu_torch.ops import hist_kernel
    from mpitree_tpu_torch.ops.binning import bin_dataset_torch
    from mpitree_tpu_torch.serving import serve_kernel
    from mpitree_tpu_torch.utils.datasets import california_like, covtype_like

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the host rung runs only where phase 31 (c) and (d) ask for it
    os.environ.pop("MPITREE_TPU_ELASTIC", None)
    warnings.filterwarnings("error", message=HOST_RUNG_WARNING)
    t_start = time.perf_counter()
    clock = {}

    def mark(phase: str) -> None:
        """Seconds since the start when ``phase`` ended."""
        clock[phase] = round(time.perf_counter() - t_start, 3)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    phase_build()

    mark("1 build")
    X, y = covtype_like(ROWS, seed=0)
    Xh, yh = covtype_like(50_000, seed=1)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    binned = bin_dataset_torch(X, max_bins=256, binning="auto", device=dev)
    torch.cuda.synchronize()
    log(f"binning: {ROWS} x {X.shape[1]} on the card in "
        f"{time.perf_counter() - t0:.3f} s, n_bins {binned.n_bins}")
    K = _chunk_size(ROWS, X.shape[1], binned.n_bins, 7,
                    BuildConfig(max_depth=DEPTH))
    y_d = torch.from_numpy(y).to(dev)
    shapes = phase_kernels(binned.x_binned, y_d, binned.n_bins, K,
                           [int(v) + 1 for v in binned.n_cand])
    del binned, y_d
    torch.cuda.empty_cache()

    mark("2 kernels")
    launches, fit_s, fit_acc, fit_tree = phase_fit(X, y, Xh, yh, DEPTH)
    mark("3 fit")
    phase_parity()
    mark("4 parity")
    forest, forest_launches, forest_acc, forest_s = phase_forest(
        X, y, Xh, yh)
    mark("5 forest")
    phase_forest_parity()
    mark("5 forest parity")
    Xbig, _ = covtype_like(SERVE_SHAPES[-1], seed=3)
    serve_shapes = phase_serve_kernels(forest, Xbig)
    mark("6 serve kernels")
    serving, serve_launches = phase_serve(forest, Xh, Xbig)
    mark("7 serve")
    hybrid_fit, hybrid_tree = phase_hybrid(X, y, Xh, yh, DEPTH, fit_acc)
    hybrid = {"fit": hybrid_fit}
    mark("8 hybrid")
    phase_parity(DEPTH, hybrid=True)
    mark("9 hybrid parity")
    hybrid["forest"] = phase_default_forest(X, y, Xh, yh, forest_acc)
    mark("10 default forest")
    phase_forest_parity(hybrid=True)

    mark("11 hybrid forest parity")
    Xc, yc = california_like(CAL_ROWS, seed=0)
    Xch, ych = california_like(50_000, seed=1)
    t0 = time.perf_counter()
    cov_binned = bin_dataset_torch(X, max_bins=256, binning="auto",
                                   device=dev)
    cal_binned = bin_dataset_torch(Xc, max_bins=256, binning="auto",
                                   device=dev)
    torch.cuda.synchronize()
    log(f"binning: {CAL_ROWS} x {Xc.shape[1]} and covtype again on the "
        f"card in {time.perf_counter() - t0:.3f} s")
    y_cal = torch.from_numpy((yc - yc.mean()).astype(np.float32)).to(dev)
    fixed_shapes = phase_fixed_kernels(
        cov_binned, torch.from_numpy(y).to(dev), cal_binned, y_cal)
    del cov_binned, cal_binned, y_cal
    torch.cuda.empty_cache()
    mark("12 fixed kernels")
    regression, reg_tree = phase_regression(Xc, yc, Xch, ych)
    mark("13 regression")
    phase_regression_parity()
    mark("14 regression parity")
    weighted = phase_weights(X, y, Xh, yh, fit_acc)
    mark("15 weights")
    subspace = phase_subspace_forests(X, y, Xh, yh, forest_acc)
    mark("16 subspace forests")
    reg_forests, reg_forest = phase_regression_forests(Xc, yc, Xch, ych)
    mark("17 regression forests")
    reg_serving = phase_serve_regression(reg_forest, Xch)
    mark("18 serve regression")
    del reg_forest
    constrained, mono_clf, mono_forest = phase_constrained(
        X, y, Xh, yh, Xc, yc, Xch, ych, regression["device"]["heldout_r2"])
    mark("19 constrained")
    persistence = phase_persistence(forest, mono_clf, Xh)
    mark("20 persistence")
    del mono_clf, mono_forest
    boost_clf, boost_reg, boosting = phase_boosting(
        X, y, Xh, yh, Xc, yc, Xch, ych)
    mark("21 boosting")
    boosting["parity"] = phase_boosting_parity()
    mark("22 boosting parity")
    boosting["serving"] = phase_boosting_serving(boost_clf, boost_reg, Xh,
                                                 Xch)
    mark("23 boosted serving")
    del boost_clf, boost_reg
    engines = phase_engines(X, y, Xc, yc, {
        "tree": dict(second_s=fit_s, launches=launches, trees=[fit_tree]),
        "forest": dict(second_s=forest_s, launches=forest_launches,
                       trees=list(forest.trees_)),
        "regressor": dict(second_s=regression["device"]["second_s"],
                          launches=regression["device"]["launches"],
                          trees=[reg_tree]),
    })
    mark("24 engines")
    leafwise, leaf_tree = phase_leafwise(X, y, Xh, yh, Xc, yc, Xch, ych)
    mark("25 leafwise")
    fused, boost_regs = phase_fused_rounds(X, y, Xh, yh, Xc, yc, Xch, ych)
    mark("26 fused rounds")
    tier = phase_serve_tier(forest, reg_tree, Xbig, Xh, Xch, args.profile)
    mark("27 serve tier")
    del Xbig
    mesh = phase_mesh(X, y, Xh, yh, fit_tree, hybrid_tree)
    mark("28 mesh")
    ensembles = phase_mesh_ensembles(X, y, Xh, Xc, yc, Xch, forest,
                                     fit_tree, leaf_tree, boost_regs)
    mark("29 mesh ensembles")
    stream = phase_stream(X, y, Xh, fit_tree, launches, hybrid_tree, Xc, yc,
                          Xch, boost_regs[FUSED_K])
    mark("30 stream")
    resilience = phase_resilience(
        X, y, Xh, fit_tree, forest, Xc, yc, Xch, boost_regs[FUSED_K],
        [r["peak_bytes"] for r in ensembles["ranks"]["b"]])
    mark("31 resilience")
    if args.profile:
        profile_all(X, y, forest, Xh, args.profile)

    kernels = []
    for route, S in REPRESENTATIVE.items():
        row = next(r for r in shapes
                   if r["route"] == route and r["S"] == (S or K))
        kernels.append(dict(
            name=f"hist_{route}[S={row['S']}]", route="cuda",
            source="mpitree_tpu_torch/csrc/histogram.cu",
            replaces=REPLACES[route], launches=launches[route],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            kernel_ms=row["kernel_ms"], sort_ms=row["sort_ms"],
            bound_int32_ms=row["bound_int32_ms"],
            forest_launches=forest_launches[route],
            subspace_forest_launches={
                k: v["launches"][route] for k, v in subspace.items()},
            constrained_fit_launches=constrained["classifier"]["launches"][
                route],
            constrained_forest_launches=constrained["forest"]["launches"][
                route],
            engine_launches={
                what: {k: v["launches"][route] for k, v in r.items()
                       if isinstance(v, dict) and "launches" in v}
                for what, r in engines.items() if what != "regressor"
                and isinstance(r, dict) and "levels" in r},
            leafwise_launches={
                sub: leafwise["budget"][sub]["launches"][route]
                for sub in ("off", "on")},
            mesh_launches={
                part: mesh[part]["launches"][route] if "launches" in
                mesh[part] else [r["launches"][route]
                                 for r in mesh[part]["ranks"]]
                for part in ("a", "b", "c", "d")},
            mesh_ensemble_launches=_ensemble_launches(ensembles, route),
            stream_launches={part: stream[part]["launches"][route]
                             for part in ("a", "b", "c")},
            resilience_launches=dict(
                {part: resilience[part]["launches"][route]
                 for part in ("a", "b", "c", "e")},
                i=[r["launches"][route] for r in resilience["i"]["ranks"]]),
        ))
    for form, (agg, chan) in SERVE_LINE.items():
        row = next(r for r in serve_shapes if r["kernel"] == form
                   and r["agg"] == agg and r["channel"] == chan
                   and r["rows"] == 4_096)
        kernels.append(dict(
            name=f"serve_{form}[agg={agg}]", route="cuda",
            source="mpitree_tpu_torch/csrc/traverse.cu",
            replaces="mpitree_tpu/serving/pallas_serve.py:49",
            launches=serve_launches[form], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None,
            library="none: no single PyTorch call computes an ensemble "
                    "traversal",
            by_rows={r["rows"]: {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "max_abs_err")}
                for r in serve_shapes if r["kernel"] == form
                and r["agg"] == agg and r["channel"] == chan},
            regression_serve_launches=reg_serving["launches"][form],
            regression_forest_mean=reg_serving["kernels"][form],
            constrained_serve_launches=constrained["forest"][
                "serve_launches"][form],
            constrained_forest_values=constrained["forest"]["kernels"][form],
            serve_tier_launches={k: v[form]
                                 for k, v in tier["launches"].items()},
            mesh_forest_serve_launches=ensembles["f"]["launches"][form],
            stream_forest_serve_launches=stream["c"]["serve_launches"][
                form],
            resilience_serve_launches={
                part: resilience[part]["launches"][form]
                for part in ("e", "g", "h")},
        ))
    for key, S in FIXED_LINE.items():
        route = key[:-len("_fixed")]
        row = next(r for r in fixed_shapes if r["payload"] == "moments"
                   and r["route"] == route and r["S"] == (S or r["K"]))
        kernels.append(dict(
            name=f"hist_{key}[S={row['S']}]", route="cuda",
            source="mpitree_tpu_torch/csrc/histogram.cu",
            replaces=REPLACES[route],
            payloads="mpitree_tpu/ops/pallas_hist.py:245-266",
            launches=regression["device"]["launches"][key],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            kernel_ms=row["kernel_ms"], sort_ms=row["sort_ms"],
            payload="moments (regression fit, phase 13)",
            weighted_fit_launches=weighted["launches"][key],
            regression_forest_launches={
                k: v["launches"][key] for k, v in reg_forests.items()},
            constrained_fit_launches=constrained["regressor"]["launches"][
                key],
            boosted_classifier_launches=boosting["classifier"]["launches"][
                key],
            boosted_regressor_launches=boosting["regressor"]["launches"][
                key],
            engine_launches={k: v["launches"][key] for k, v in
                             engines["regressor"].items()
                             if isinstance(v, dict) and "launches" in v},
            leafwise_regressor_launches=leafwise["regressor"]["launches"][
                key],
            fused_rounds_launches={
                f"{what} K={K}": fused[what][K]["launches"][key]
                for what in ("regressor", "classifier")
                for K in (1, FUSED_K)},
            mesh_ensemble_launches=_ensemble_launches(ensembles, key),
            stream_launches=stream["d"]["launches"][key],
            resilience_launches={"f": resilience["f"]["launches"][key]},
        ))
    for form in SERVE_LINE:
        for what in ("classifier", "regressor"):
            sv = boosting["serving"][what]
            row = sv["kernels"][form]
            kernels.append(dict(
                name=f"serve_{form}[agg=percls, margin, {what}]",
                route="cuda", source="mpitree_tpu_torch/csrc/traverse.cu",
                replaces="mpitree_tpu/serving/pallas_serve.py:49",
                launches=sv["launches"][form],
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=None,
                library="none: no single PyTorch call computes an "
                        "ensemble traversal",
                rows=row["rows"], n_out=row["n_out"], trees=sv["trees"],
            ))
    # the leaf-wise frontier's sibling pair: the stream routes at S = 2
    for key, payload in (("stream", None), ("stream_fixed", "moments")):
        route = key.split("_")[0]
        row = next(r for r in (shapes if payload is None else fixed_shapes)
                   if r["S"] == 2 and r.get("payload") == payload)
        if row["route"] != route:
            raise AssertionError(f"S=2 planned {row['route']}, not {route}")
        kernels.append(dict(
            name=f"hist_{key}[S=2, leaf-wise pair]", route="cuda",
            source="mpitree_tpu_torch/csrc/histogram.cu",
            replaces=REPLACES[route], launches=(
                leafwise["budget"]["off"]["launches"][key]
                if payload is None else
                leafwise["regressor"]["launches"][key]),
            launches_of=("phase 25 (b), subtraction off" if payload is None
                         else "phase 25 (c)"),
            mesh_ensemble_launches=_ensemble_launches(ensembles, key),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            payload=payload or "class counts"))
    if (set(hist_kernel.launches) != set(REPRESENTATIVE) | set(FIXED_LINE)
            or set(serve_kernel.launches) != set(SERVE_LINE)):
        raise AssertionError("kernels line does not cover every kernel")
    log(f"total: {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernel_shapes": shapes}))
    log(json.dumps({"serve_kernel_shapes": serve_shapes}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"hybrid": hybrid}))
    log(json.dumps({"fixed_kernel_shapes": fixed_shapes}))
    log(json.dumps({"regression": regression}))
    log(json.dumps({"weights": weighted}))
    log(json.dumps({"subspace_forests": subspace}))
    log(json.dumps({"regression_forests": reg_forests}))
    log(json.dumps({"regression_serving": reg_serving}))
    log(json.dumps({"constrained": constrained}))
    log(json.dumps({"persistence": persistence}))
    log(json.dumps({"boosting": boosting}))
    log(json.dumps({"engines": engines}))
    log(json.dumps({"leafwise": leafwise}))
    log(json.dumps({"fused_rounds": fused}))
    log(json.dumps({"serve_tier": tier}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"mesh_ensembles": ensembles}))
    log(json.dumps({"stream": stream}))
    log(json.dumps({"resilience": resilience}))
    log(json.dumps({"phase_end_s": clock}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
