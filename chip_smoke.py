#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bialign_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py --kernels-only     # phases 1-3, then stop
    python3 chip_smoke.py --fills-only       # phases 1-2 and the fills' times
    python3 chip_smoke.py --tile-times       # phases 1-2 and the tile kernels'
    python3 chip_smoke.py --walk-times       # phases 1-2 and the walks' times
    python3 chip_smoke.py --stream-only      # phases 1-2 and the stream,
                                             # its double buffer measured
    python3 chip_smoke.py --mesh-only        # phases 1-2, the split's
                                             # kernels and the mesh phase
    python3 chip_smoke.py --split-only       # phases 1-2 and the split
                                             # alone (on several cards)
    python3 chip_smoke.py --triplet-only     # phases 1-2 and the triplet:
                                             # its kernel, path and times
    python3 chip_smoke.py --resident-only    # phases 1-2, K3's and the
                                             # triplet's checks and times
                                             # (both routes "resident")
    python3 chip_smoke.py --profile-stress   # phases 1-2 and phase 8, with
                                             # in-process traces recorded
    python3 chip_smoke.py --fuzz-only        # phases 1-2 and the fuzz
                                             # phase (--fuzz-seconds N)
    python3 chip_smoke.py --pair-tables-only # phases 1-2 and the pair's
                                             # tables built on the card

Needs one CUDA card and nvcc; imports no JAX and nothing of the JAX
package.  Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds csrc/*.cu into build/bialign_tpu_torch/ (unless the
   library there is newer than every source);
3. kernels: each CUDA kernel against its plain PyTorch twin on the card,
   on random tables at small to medium shapes and at the edges of the tile
   kernels' CTAs (R-1, R, R+1 and 2R+1 live rows at max_shift 1 and 3) and
   max_shift 4 (bands, last slabs and traces exact; the band fills also on
   a band of garbage, the score-only kernels on a ring of garbage).
   The bucket kernels K4-K8 on buckets of mixed lengths at max_shift 0-4,
   B from 1 to 64, and on buckets at the tile's edges (pairs of R-1, R and
   R+1 live rows, empty sequences) at max_shift 0-4, rings of garbage,
   every route forced ("cta" wherever the bucket fits one CTA's shared
   memory, at three thread counts a CTA, every cell of the rings it leaves
   equal to the single-pair twins' on buckets of up to 16 pairs; the
   conveyor on one lane, on three and on one per pair), all equal.  K3 on
   its three routes (one CTA; "resident", one cooperative grid, at its own
   CTAs and at 3 CTAs of 32 threads; a launch a diagonal) from the same
   ring of garbage, every cell of the ring equal to the twin's, up to the
   DNA-Pol-1 shape; the pairs beyond one CTA (4096x4090, 8192x8180) on
   their own route, "resident", its ring equal to the per-diagonal route's
   from the same garbage and its last slab to K1's at max_shift 0, the
   one-CTA route refused there.  K4 and K5 in band mode and the batch
   walks on the same buckets, on bands pre-filled with garbage: the bands
   equal to their twins' cell for cell (so nothing but a pair's genuine
   cells is written), the scores equal to score mode's, every walk equal to
   the host walk over the pair's own band.  The checkpointed path's
   kernels K9-K12 and the blockwise walks at the same shapes, each at
   several block sizes C (1, 7, the default, one beyond n+m), on rings,
   checkpoint buffers and windows of garbage: checkpoints and last slab
   equal to the twin's in every cell, every block's window equal to what
   the twin's band gives (and to the block twin itself), every block walk's
   state and codes equal to the host walk's over the same window, and the
   blockwise traceback equal to the full-band device walk.  The sequence
   split's six entry points (csrc/seqsplit.cu: score-only, checkpointed
   and block fills over K row shards) on both routes ("streams": a stream
   a shard; "resident": one cooperative launch a card, at its default
   rows a CTA and at a row a CTA) at K = 1, 2 and 3 (a shard of one row at
   each end), max_shift 0-4, on rings, checkpoints and windows of garbage,
   every cell equal to their twins'.  The walks
   again on tie-heavy tables (values in {0, +-100}, costs of the same
   grain: many co-optimal cases a step, the first-minimum rule deciding),
   single-pair, block by block and batched, each equal to the host walk
   over the same device memory.  The triplet fill (csrc/triplet.cu), every
   route ("shared" wherever triplet_route gives it, else a forced
   "shared" must raise; "global" everywhere; "cluster" on clusters of 3
   and 8 CTAs wherever cluster_shape holds the pair, else a forced
   "cluster" must raise; "resident" on its own grid and on 3 CTAs) against
   its twin fill_slabs on slabs of garbage:
   n and m of 0-2, 31-33, 63-65 and 1023-1025 mixed, max_shift 0-4 and
   beyond the compiled widths, a CTA of 1024 threads and of 100, random,
   tie-heavy and int32-wrapping tables; the domain's cells equal to the
   twin's, every other cell keeping its garbage.
   Beside phase 3, in a process of its own (--fuzz-only), the fuzz
   phase: every kernel of KERNELS against its twin on
   garbage over the seeded cases of tests/torch_fuzz_cases.py (the
   generator of the CPU tests): n and m up to 300, max_shift up to each
   family's limit (17 affine, 48 non-affine, the triplet on both sides of
   its route boundary at 8, K3 across its 1024 rows), random costs in
   [-500, 200] and the corner sets (zero gap costs, a positive shift
   reward, gamma > delta, beta = gamma = delta), random, tie-heavy and
   int32-edge tables, uneven shards and forced routes; the DNA-Pol-1 pair
   through BiAligner at max_shift 3 (the golden 771550), 5 and 8 against
   the twin's score; tables beyond the int32 certificate through BiAligner
   (the int64 engine, no kernel launched).  Rounds of one case a family
   until FUZZ_SECONDS; its line {"fuzz": {kernel: {"cases", "max_abs_err"}}}
   is printed before the kernels line.  Beside phase 3 too, the port's three
   examples (examples/*_torch.py), each in a process of its own: the
   README walkthrough (6800, 48500, the golden lines), the DNA-Pol-1
   pipeline (761500) and the stream of 32 pairs (its spool equal to the
   plain twins' stream on the card, checked after phase 3);
4. goldens: the toy RNA/protein goldens and the DNA-Pol-1 prefix-150 score
   through bialign_tpu_torch.BiAligner, and one CLI run in a subprocess;
5. full size, the DNA-Pol-1 928x933 pair.  The band path: affine max_shift
   1 (SCORE 761500 and the six md5 row anchors of tests/test_dnapol.py),
   and the CLI defaults (non-affine, max_shift 2) against the plain twins.
   The protein pair's tables built on the card from codes (BiAligner's
   device route): the toy protein, DNA-Pol-1 and its CLI defaults, each
   route's tables equal to the host tables and its int32 verdict to the
   host check, the goldens (48500 and its lines, 761500 and the md5
   anchors) through it, and the constructor's and the pair's ms on both
   routes in turns (--pair-tables-only runs this alone).
   The score-only path through the port's tables: affine_score = 761500,
   at max_shift 0 (K3, one CTA) and 2 and nonaffine_score at the CLI
   defaults equal to the band path's; and a pair beyond one CTA at
   max_shift 0 (K3 on its route "resident", and a launch a diagonal
   forced) equal to K1's score.  End-to-end
   times, kernel times against the plain
   twins', microseconds a launch, the score-only fills beside the bucket
   kernels K4/K5 on the same pair as a batch of one (the same tile under
   the bucket's launch), band bytes, peak memory.
   Then a 4000x3990 pair of random tables, affine max_shift 1: score-only
   against the band kernel; at max_shift 0, K3 on its three routes in turns
   against K1; K3's "resident" and per-diagonal routes in turns at
   4096x4090 and 8192x8180 (the kernels line's K3 "resident" at the first,
   beside its twin).
   The batched-scores path through bialign_tpu_torch.parallel.score_batch
   and PreparedBatch: 64 windows of 128-508 residues of the DNA-Pol-1 pair
   (affine max_shift 1, bucket_quantum 128; buckets beyond one CTA's shared
   memory, so the conveyor K8), every score equal to the single-pair
   affine_score; 512 copies of the 42x42 toy protein pair in one 64x64
   bucket (K6), all 48500, the same at max_shift 0 (K7) and at the
   non-affine CLI defaults (K6 non-affine); four copies of the whole
   DNA-Pol-1 pair, non-affine (K8 non-affine); and that pair as a batch of
   one, affine (K4, 761500) and non-affine (K5).  Pairs/s and 4-D cells/s
   from host
   tables and from resident ones, cold and warm, kernel times against the
   twins' and against the pairs one at a time, the routes and the
   conveyor's lanes against each other, K6's threads a CTA (256, 512,
   1024) against each other, peak memory; K4, K5 and K8 on the
   64 windows (K5 and K8's non-affine form under the CLI defaults' costs),
   in total and a launch.
   The batched-alignments path through parallel.align_batch: the same 64
   windows (every score equal to affine_score, every trace and complete
   flag equal to the single-pair BiAligner's), 512 toy pairs (48500 and the
   golden lines), the whole DNA-Pol-1 pair as a batch of one (761500 and
   the md5 anchors), four DNA-Pol-1 pairs non-affine (288000), the
   max_shift 3 goldens; and the codes path: the 64 windows from their raw
   sequences through dispatch_score_batch_codes and
   dispatch_align_batch_codes with the BLOSUM62 table resident on the card,
   equal to the tables path.  Alignments/s from tables and from codes beside
   the same pairs one at a time, stage times, peak memory at the card's
   band budget and at 2 GiB, host-to-device bytes of both paths.
   The low-memory path through BiAligner(lowmem=True): the DNA-Pol-1 pair,
   affine max_shift 1 (761500, the md5 anchors), max_shift 2 and the
   non-affine CLI defaults, every trace equal to the band path's; the toy
   and max_shift 3 goldens at small block sizes; one --lowmem CLI run; the
   4000x3990 pair against the band kernel and its walk, with both peak
   memories; and a 13000x12990 pair whose band (109 GB) the card cannot
   hold: score equal to affine_score, trace complete and replayed on the
   host to that score.  Times of the checkpointed fill beside the
   score-only fill, of the block fills and block walks, peak bytes.
   The stream (run after phase 7): 1024 windows of the DNA-Pol-1 pair
   (seeds 0-15) with a copy of the whole pair before every 128th, through
   parallel.StreamingAligner in chunks of 256 pairs (affine max_shift 1):
   scores and alignments, from tables and from codes, every score, trace,
   complete flag and spool record equal to score_batch / align_batch on
   the same records, every whole copy 761500 with the md5 anchors, the
   alignments' peak memory, with two chunks in flight, between the largest
   band of one dispatch and that band with its bucket's tables (+ 1 GiB);
   256 windows at the non-affine CLI defaults (scores, alignments); 512 toy
   pairs at max_shift 1 and 0; a resume after the spool's last line is cut
   in half (every id once, equal to a one-shot run's spool); the batch CLI
   in two processes on the card (RANK 0/1, disjoint shards whose merge is
   one process's spool); --render on 16 windows, equal to BiAligner's
   lines; the warmup in a fresh process.  Rates, RunStats, peak
   memory.  With --stream-only also the alignments serial and
   double-buffered in turns (the share of the host's work the double
   buffer hides);
   The mesh phase (shards on distinct cards when the host has several,
   else all on cuda:0, a stream each; the device count and the layout
   printed): the DNA-Pol-1 pair through BiAligner(seqsplit_mesh=) at K = 2
   and 4 on the split's own route ("resident"), and at K = 2 forced onto
   route "streams", affine max_shift 1 (761500, the md5 anchors) and the
   non-affine CLI defaults, each score, line and trace equal to the
   one-device low-memory path's; score_seqsplit there (equal to
   affine_score and nonaffine_score) and on the 4000x3990 pair at K = 4;
   the 64 windows' scores and alignments from tables and from codes over
   "data" meshes of 2 and 4, and the stream's scores and alignments from
   codes over a mesh of 2, each equal to one device pair by pair, with the
   rates of both.  The split's entries on both routes at DNA-Pol-1 on 2
   shards against their twins on garbage, timed; both routes in turns at
   K = 1, 2, 4 (score-only, checkpointed, one block, all the band's
   blocks) beside the one-device fills, and at 4000x3990, K = 4; in phase
   7, a profiled K = 4 fill on each route (the halo copies' share on
   "streams", one kernel a card on "resident").
   The triplet aligner through BiAlignerTriplet on its default engine, the
   CUDA kernel: the DNA-Pol-1 pair at max_shift 1 with flat gaps on route
   "shared" (779500; score, trace, the three rows, the six with structures
   and the eval_trace lines equal to the plain twin's on the CPU), a
   1500 x 1490 pair at max_shift 8 on its own route (its ring, 306 KB,
   beyond one CTA; score 1246400, equal to the twin's last cell), that
   pair's fill also forced onto the other routes, and a 7000 x 6990 pair at
   max_shift 8 on route "resident" (no portable cluster holds it; its
   slabs, 6.66 GB, copied back once, equal to route "global"'s on the
   domain, its score to that route's last cell); at DNA-Pol-1 the slabs of
   every route (and of "shared" on 480 threads, the tables staged, of
   "cluster" on 2, 4 and 8 CTAs, of "resident" on its own grid) equal to
   the twin's on the card, at 1500 x 1490 the slabs of "global",
   "resident" and "cluster" on 2, 4, 8 and 16 CTAs; each kernel's time
   alone (CUDA events, warm, in turns) and through its wrapper beside
   optimize() end to end and its stages (at both pairs), the twin on the
   card and on the CPU, the bounds and chain floors; "resident" and
   "global" in turns at 7000 x 6990, "resident" and "cluster" in turns at
   the low end of "cluster"'s range (max_shift 8, 4 and 1); the kernel on
   a 200 x 200 window against fill_oracle in every banded cell;
6. launch counts of the eight paths (the five above, the mesh phase, the
   triplet, its four routes, and the stream), counted apart, each of
   which must be > 0;
7. profile: where the time of the DNA-Pol-1 runs and of the two batches
   goes, stage by stage on the host clock and from a torch.profiler trace
   (device busy and idle time, per-kernel times; score-only K3 as its one
   kernel), the split's K = 4 score-only fill on route "streams" (the halo
   copies' share) and on route "resident" (one kernel a card),
   and the device's busy time in one double-buffered run of the stream's
   alignments from codes; each measurement in a process of its own
   (--profile-one), all set up at once (tables, warm-up, the profiler's
   session) and measuring in turn, so that no trace follows another in one
   process and nothing runs on the card between a session's set-up and its
   trace; traces and report in build/profile/;
8. stress: a large trace (the split's K = 4 fill twice, ~15,000 device
   events), then 20 DNA-Pol-1 band-path traces, each in a process of its
   own, each holding all n+m+1 DP kernels; --profile-stress also takes 20
   such traces in the process of the large one and records their counts,
   and two whose prepared session idles 30 s or sees a run first.

--tile-times builds, then times the tile kernels K1, K2, K4, K5, K8 and
K9-K12 alone at the DNA-Pol-1 shapes and on the realistic batch (no
twins), through calls that every checkout since those kernels has: copied
into an unpacked older checkout and run there, it times that checkout's
kernels, so two checkouts compare in one chip call.  --walk-times does the
same for the walk kernels (csrc/walk.cu, through their C functions): the
single-pair walks at the DNA-Pol-1 shapes and at 4000x3990, the realistic
batch's batch walks and the DNA-Pol-1 low-memory traceback's block walks,
ms and microseconds a step; where the checkout has csrc/probe.cu, also the
pointer-chase probe's ns a dependent load (device memory, L2) and each
walk's chain floor, steps x that latency.  The whole run prints the probe
too, after phase 5's kernel times.

Then the fuzz line, one JSON line of per-kernel results (with each
kernel's bound: the least time the card could take for the same work), and
last the line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then
nonzero and that line is not printed.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import functools
import hashlib
import importlib.util
import io
import json
import os
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bialign_tpu_torch import BiAligner, BiAlignerTriplet, _build
from bialign_tpu_torch import aligner as pair_aligner
from bialign_tpu_torch.convert import tables_to_torch
from bialign_tpu_torch.data import dnapol_pair
from bialign_tpu_torch.ops import checkpoint_dp as ckp
from bialign_tpu_torch.ops import cuda_dp
from bialign_tpu_torch.ops import device_traceback as dtb
from bialign_tpu_torch.models import triplet as trip
from bialign_tpu_torch.ops.cases import (affine_score_multiplicities,
                                         check_int32_safe)
from bialign_tpu_torch.parallel import batch as pbatch
from bialign_tpu_torch.parallel import batch_cli
from bialign_tpu_torch.parallel.driver import (PairRecord, StreamingAligner,
                                               merge_spools, trace_to_codes)
from bialign_tpu_torch.scoring import pair_codes
from bialign_tpu_torch.scoring.tables import _sim_lut, build_score_tables
from bialign_tpu_torch.utils import profiling

try:    # checkouts before the sequence split lack it: --tile-times and
    # --walk-times run this script in them too
    from bialign_tpu_torch.parallel import Mesh
    from bialign_tpu_torch.parallel import seqsplit as ssp
except ImportError:
    Mesh = ssp = None

ROOT = Path(__file__).resolve().parent
SEED = 0

# (n, m, max_shift) of phase 3
SHAPES = [(1, 1, 1), (5, 7, 1), (8, 8, 2), (12, 3, 1), (7, 9, 0),
          (33, 40, 3), (150, 150, 1), (300, 257, 2), (0, 5, 1), (6, 0, 2)]


def tile_edge_shapes() -> list:
    """Shapes at the edges of the tile kernels' CTAs (csrc/tile_diag.cuh):
    middle diagonals of R-1, R, R+1 and 2R+1 live rows for the R rows of an
    affine and of a non-affine tile at max_shift 1 and 3; and one at
    max_shift 4, which the kernel takes with S read at run time."""
    shapes = set()
    for S in (1, 3):
        for rows in cuda_dp.TILE_ROWS:                   # affine, non-affine
            R = rows[S]
            shapes |= {(live - 1, live + 2, S)
                       for live in (R - 1, R, R + 1, 2 * R + 1)}
    return sorted(shapes, key=lambda s: (s[2], s[0])) + [(9, 11, 4)]


TILE_EDGE_SHAPES = tile_edge_shapes()


def edge_lengths(N: int, M: int, S: int) -> list:
    """(n, m) of a bucket at the tile's edges: pairs whose widest live
    range, min(n, m) + 1 rows, is R-1, R and R+1 rows for the R of the
    affine and of the non-affine tile at max_shift S, an empty sequence
    each way and the bucket's own size."""
    out = [(0, M), (N, 0), (N, M)]
    for R in sorted({cuda_dp.tile_rows(S, True), cuda_dp.tile_rows(S, False)}):
        out += [(w - 1, w + 1) for w in (R - 1, R, R + 1) if w >= 1]
    return out


# Buckets of phase 3 at the tile's edges (edge_lengths), max_shift 0-4:
# (N, M, max_shift), N + 1 the rows of the larger tile and 2
EDGE_BUCKETS = [(R + 1, R + 2, S) for S in range(5)
                for R in [max(cuda_dp.tile_rows(S, a) for a in (True, False))]]
AFFINE_PARAMS = (-150, -50, -150)       # beta, gamma, delta
NONAFFINE_PARAMS = (-200, -250)         # gamma, delta

DNAPOL_FULL = dict(type="Protein", shift_cost=-150, structure_weight=800,
                   simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
                   max_shift=1)                     # tests/test_dnapol.py:76-82
DNAPOL_PREFIX = dict(type="Protein", shift_cost=-210, structure_weight=800,
                     simmatrix="BLOSUM62", gap_opening_cost=-200,
                     gap_cost=-50, max_shift=1)     # tests/test_dnapol.py:15-23
DNAPOL_CLI_DEFAULTS = dict(type="Protein")         # non-affine, max_shift 2
MS0_SHAPES = [(7, 9), (1, 1), (0, 3), (5, 0), (20, 13)]   # (n, m) for K3
DNAPOL_SHAPE = (928, 933)
# the shortest pair that does not fit one CTA of K3 (4096 rows, four a
# thread), and one of twice its rows (its tables 536 MB): K3's route
# "resident" against the per-diagonal route and K1; and the pairs at which
# "resident" and the one-CTA route are timed in turns
MS0_BEYOND = (4096, 4090)
MS0_BIG = (8192, 8180)
MS0_ROUTE_SHAPES = ((512, 510), (1024, 1014), (2048, 2038), (3072, 3062),
                    (4000, 3990))
# threads a CTA of the one-CTA kernels in phase 3: the kernel's own, two
# warps, the most; the rings they leave are held to the single-pair twins'
# on buckets of up to CTA_TWIN_PAIRS pairs
CTA_THREADS = (None, 64, 1024)
CTA_TWIN_PAIRS = 16
# K6's threads a CTA timed against each other
CTA_SWEEP = (256, 512, 1024)
BIG_PAIR = (4000, 3990, 1)              # README: a synthetic protein pair
# a pair whose band [n+m+1, 9, 3, 3, n+1] int32 (109 GB) no card holds
HUGE_PAIR = (13000, 12990, 1)
# block sizes of phase 3 beside the default: every diagonal a block, a
# small odd one, and (from n + m) one block for the whole band
SMALL_BLOCKS = (1, 7)
# phase 3 runs the block twins on every block up to this many diagonals,
# beyond it on the first, the middle and the last block
BLOCK_TWIN_DIAGONALS = 100
# Tie-heavy walks of phase 3: tables of values in {0, +-100} and costs of
# the same grain, so that many cases of a step are co-optimal and the
# first-minimum rule decides it; (n, m, max_shift) of the single-pair and
# blockwise walks, and the (N, M, B) bucket of the batch walks
TIE_AFFINE_PARAMS = (-200, -100, -100)  # beta, gamma, delta
TIE_NONAFFINE_PARAMS = (-100, -100)     # gamma, delta
TIE_VALUES = (-1, 2)                    # x 100, numpy's half-open range
TIE_SHAPES = [(7, 10, 1), (16, 19, 1), (5, 7, 0), (8, 8, 2), (33, 40, 3),
              (5, 6, 4), (150, 150, 1), (300, 257, 2)]
TIE_BUCKET = (64, 64, 16)
# The pointer-chase probe (csrc/probe.cu): a buffer the size of the
# DNA-Pol-1 band at max_shift 1 (its lines cold) and one inside the L2
# (warm), one 128-byte line a hop
PROBE_BYTES = {"hbm": 560 << 20, "l2": 8 << 20}
PROBE_HOPS = 100_000

# Buckets of phase 3: (N, M, B, the max_shifts to run).  Lengths are mixed
# inside each bucket (mixed_lengths); the last has 150-300 rows.
BUCKETS = [(8, 8, 1, (0, 1, 2, 3)), (8, 8, 7, (0, 1, 2, 3, 4)),
           (24, 40, 16, (1, 2)), (64, 64, 64, (0, 1, 2)),
           (200, 257, 5, (0, 1, 2))]
# The conveyor's own twin walks every step in Python: it runs where the
# steps are at most this many.
CONVEYOR_TWIN_STEPS = 400
# The two batches of phase 5 (bench.py:92-100, :338, :488): the toy protein
# pair and windows of the DNA-Pol-1 pair, both with DNAPOL_FULL's costs.
TOY = dict(seqA="RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR",
           seqB="KAKLPLKEKKLTRTANYHPGIRYIMTGYSAKRIYSSTYAYFR",
           strA="CHHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEEEECCC",
           strB="HHHHHHHHHHHHCCCCCCTCEEEEEEECCCCCEEEEEEEECC")
TOY_SCORE = 48500
TOY_PAIRS = 512
REALISTIC_PAIRS, REALISTIC_LO, REALISTIC_HI = 64, 128, 508
REALISTIC_QUANTUM = 128
FULL_COPIES = 4                          # the non-affine bucket of K8

# Peaks of one H100 SXM for the kernels' bounds: device memory 3.35 TB/s;
# int32 on the CUDA cores 132 SMs x 64 lanes x 1.98 GHz (boost) = 16.7e12
# operations a second.  These kernels have no tensor-core form.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9

KERNELS = {
    # name: (source, the TPU-side program it replaces)
    "fill_affine": ("bialign_tpu_torch/csrc/fill_affine.cu",
                    "bialign_tpu/ops/pallas_dp.py:542"),
    "fill_nonaffine": ("bialign_tpu_torch/csrc/fill_nonaffine.cu",
                       "bialign_tpu/ops/pallas_dp.py:414"),
    "score_affine": ("bialign_tpu_torch/csrc/score_affine.cu",
                     "bialign_tpu/ops/pallas_dp.py:542"),
    "score_nonaffine": ("bialign_tpu_torch/csrc/score_nonaffine.cu",
                        "bialign_tpu/ops/pallas_dp.py:414"),
    "score_affine_ms0": ("bialign_tpu_torch/csrc/score_affine_ms0.cu",
                         "bialign_tpu/ops/pallas_dp.py:741"),
    "score_affine_ms0_grid": ("bialign_tpu_torch/csrc/score_affine_ms0.cu",
                              "bialign_tpu/ops/pallas_dp.py:741"),
    "batch_affine": ("bialign_tpu_torch/csrc/batch_affine.cu",
                     "bialign_tpu/ops/pallas_dp.py:1004"),
    "batch_nonaffine": ("bialign_tpu_torch/csrc/batch_nonaffine.cu",
                        "bialign_tpu/ops/pallas_dp.py:1402"),
    "cta_scores": ("bialign_tpu_torch/csrc/cta_scores.cu",
                   "bialign_tpu/ops/pallas_dp.py:1102"),
    "cta_scores_ms0": ("bialign_tpu_torch/csrc/cta_scores_ms0.cu",
                       "bialign_tpu/ops/pallas_dp.py:1157"),
    "conveyor_scores": ("bialign_tpu_torch/csrc/conveyor_scores.cu",
                        "bialign_tpu/ops/pallas_dp.py:1593"),
    "walk_affine": ("bialign_tpu_torch/csrc/walk.cu",
                    "bialign_tpu/ops/device_traceback.py:85"),
    "walk_nonaffine": ("bialign_tpu_torch/csrc/walk.cu",
                       "bialign_tpu/ops/device_traceback.py:304"),
    "batch_fill_affine": ("bialign_tpu_torch/csrc/batch_affine.cu",
                          "bialign_tpu/ops/pallas_dp.py:1004"),
    "batch_fill_nonaffine": ("bialign_tpu_torch/csrc/batch_nonaffine.cu",
                             "bialign_tpu/ops/pallas_dp.py:1402"),
    "walk_affine_batch": ("bialign_tpu_torch/csrc/walk.cu",
                          "bialign_tpu/ops/device_traceback.py:264"),
    "walk_nonaffine_batch": ("bialign_tpu_torch/csrc/walk.cu",
                             "bialign_tpu/ops/device_traceback.py:291"),
    "ckpt_affine": ("bialign_tpu_torch/csrc/ckpt_affine.cu",
                    "bialign_tpu/ops/pallas_dp.py:1944"),
    "ckpt_nonaffine": ("bialign_tpu_torch/csrc/ckpt_nonaffine.cu",
                       "bialign_tpu/ops/pallas_dp.py:2151"),
    "block_affine": ("bialign_tpu_torch/csrc/block_affine.cu",
                     "bialign_tpu/ops/pallas_dp.py:2065"),
    "block_nonaffine": ("bialign_tpu_torch/csrc/block_nonaffine.cu",
                        "bialign_tpu/ops/pallas_dp.py:2243"),
    "walk_affine_block": ("bialign_tpu_torch/csrc/walk.cu",
                          "bialign_tpu/ops/checkpoint_dp.py:362"),
    "walk_nonaffine_block": ("bialign_tpu_torch/csrc/walk.cu",
                             "bialign_tpu/ops/checkpoint_dp.py:451"),
    # the sequence split's entry points (the tile kernel in its row-shard
    # form); the JAX package runs them on the XLA step, under shard_map
    "seqsplit_score_affine": ("bialign_tpu_torch/csrc/seqsplit.cu",
                              "bialign_tpu/parallel/seqsplit.py:139"),
    "seqsplit_score_nonaffine": ("bialign_tpu_torch/csrc/seqsplit.cu",
                                 "bialign_tpu/parallel/seqsplit.py:139"),
    "seqsplit_ckpt_affine": ("bialign_tpu_torch/csrc/seqsplit.cu",
                             "bialign_tpu/parallel/seqsplit.py:244"),
    "seqsplit_ckpt_nonaffine": ("bialign_tpu_torch/csrc/seqsplit.cu",
                                "bialign_tpu/parallel/seqsplit.py:244"),
    "seqsplit_block_affine": ("bialign_tpu_torch/csrc/seqsplit.cu",
                              "bialign_tpu/parallel/seqsplit.py:285"),
    "seqsplit_block_nonaffine": ("bialign_tpu_torch/csrc/seqsplit.cu",
                                 "bialign_tpu/parallel/seqsplit.py:285"),
    # ... on route "resident": one cooperative launch a card for the call,
    # flags between neighbouring CTAs
    **{f"seqsplit_resident_{what}_{kind}": (
        "bialign_tpu_torch/csrc/seqsplit.cu",
        f"bialign_tpu/parallel/seqsplit.py:{line}")
       for what, line in (("score", 139), ("ckpt", 244), ("block", 285))
       for kind in ("affine", "nonaffine")},
    # the triplet aligner's fill, route "shared" (the last three diagonals
    # in shared memory), route "cluster" (pairs beyond one CTA's ring: the
    # rows split over a thread-block cluster) and route "global" (pairs that
    # no cluster holds); the JAX package runs it as an XLA scan
    "triplet_fill_shared": ("bialign_tpu_torch/csrc/triplet.cu",
                            "bialign_tpu/models/triplet.py:188"),
    "triplet_fill_cluster": ("bialign_tpu_torch/csrc/triplet.cu",
                             "bialign_tpu/models/triplet.py:188"),
    "triplet_fill_global": ("bialign_tpu_torch/csrc/triplet.cu",
                            "bialign_tpu/models/triplet.py:188"),
    # route "resident" of the triplet fill (one cooperative grid, the halo
    # through device memory under progress flags) and of K3 (the same, for
    # one pair's score beyond one CTA)
    "triplet_fill_resident": ("bialign_tpu_torch/csrc/triplet.cu",
                              "bialign_tpu/models/triplet.py:188"),
    "score_affine_ms0_resident": ("bialign_tpu_torch/csrc/score_affine_ms0.cu",
                                  "bialign_tpu/ops/pallas_dp.py:741"),
}

# the kernels of each counted path
PATHS = {
    "band": ("fill_affine", "fill_nonaffine", "walk_affine",
             "walk_nonaffine"),
    "score_only": ("score_affine", "score_nonaffine", "score_affine_ms0",
                   "score_affine_ms0_resident", "score_affine_ms0_grid"),
    "batch": ("batch_affine", "batch_nonaffine", "cta_scores",
              "cta_scores_ms0", "conveyor_scores"),
    "align": ("batch_fill_affine", "batch_fill_nonaffine",
              "walk_affine_batch", "walk_nonaffine_batch"),
    "lowmem": ("ckpt_affine", "ckpt_nonaffine", "block_affine",
               "block_nonaffine", "walk_affine_block",
               "walk_nonaffine_block"),
    # the streaming driver (phase 5, stream): the bucket kernels on the
    # routes its chunks take, in score and band mode, and the batch walks
    "stream": ("conveyor_scores", "cta_scores", "cta_scores_ms0",
               "batch_fill_affine", "batch_fill_nonaffine",
               "walk_affine_batch", "walk_nonaffine_batch"),
    # the mesh phase: the sequence split through BiAligner(seqsplit_mesh=)
    # and score_seqsplit on their route, "resident", and forced onto route
    # "streams", with the block walks; the batch and the stream over a
    # "data" mesh, on the routes their buckets take
    "seqsplit": tuple(f"seqsplit_{route}{what}_{kind}"
                      for route in ("resident_", "")
                      for what in ("score", "ckpt", "block")
                      for kind in ("affine", "nonaffine"))
    + ("walk_affine_block", "walk_nonaffine_block"),
    "mesh": ("conveyor_scores", "cta_scores", "batch_fill_affine",
             "walk_affine_batch"),
    # the triplet aligner through BiAlignerTriplet on its default engine:
    # DNA-Pol-1 on route "shared", a pair beyond one CTA on its own route,
    # a pair beyond any portable cluster on "resident"; the other routes
    # forced through fill_slabs_cuda
    "triplet": ("triplet_fill_shared", "triplet_fill_cluster",
                "triplet_fill_resident", "triplet_fill_global"),
}

# The goldens at max_shift 3 (computed with the JAX package, engines "xla"
# and "numpy" agreeing): the toy protein pair, whose optimum needs no shift
# beyond 1, and the same sequence twice with the second structure five
# residues late, which only max_shift 3 brings together (43950 at 2).
MS3_PARAMS = dict(type="Protein", shift_cost=-150, structure_weight=800,
                  simmatrix="BLOSUM62", gap_opening_cost=-150, gap_cost=-50,
                  max_shift=3)
MS3_GOLDENS = {
    "toy_protein": (TOY, 48500, [
        "A               -RAKLPLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYAR-FR",
        "B               -KAKLPLKEKKLTRTANYHPGIRYIMTGYSAKRIYSSTYAY-FR",
        "A ss            CHHHHHHHHHHHH-HCCCCTCEEEEEEECCTC-EEEEEEEECCC",
        "B ss            -HHHHHHHHHHHHCCCCCCTCEEEEEEECCCCCEEEEEEEE-CC",
        "A shifts        >............<..................<........>..",
        "B shifts        ............................................"]),
    "structure_offset_5": (
        dict(seqA=TOY["seqA"], seqB=TOY["seqA"], strA=TOY["strA"],
             strB="CCCCC" + TOY["strA"][:-5]), 49200, [
        "A               RAKL--PLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR---",
        "B               RAKL--PLKEKKLTATANYHPGIRYIMTGYSAKYIYSSTYARFR---",
        "A ss            C-----HHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEEEECCC",
        "B ss            CCCCCCHHHHHHHHHHHHHCCCCTCEEEEEEECCTCEEEEEE-----",
        "A shifts        .<<<........................................>>>",
        "B shifts        ....>>....................................<<..."]),
}
TPU_SIZED_BUDGET = 2 << 30     # the band budget of the JAX package's chunks

# The stream phase: 16 x 64 realistic windows (seeds 0-15) with a copy of
# the whole DNA-Pol-1 pair before every 128th, through StreamingAligner in
# chunks of 256 pairs and buckets of 64 rows; the first 256 windows at the
# non-affine CLI defaults and through two batch CLI processes, 16 through
# --render
STREAM_SEEDS = 16
STREAM_FULL_EVERY = 128
STREAM_CHUNK, STREAM_QUANTUM = 256, 64
STREAM_SUBSET = 256
STREAM_RENDER = 16

# The triplet aligner: the DNA-Pol-1 pair with flat gaps (the affine
# parameters but the gap opening), on route "shared"; its fill also on a
# window of 200 x 200 residues against the oracle; and a pair of
# TRIPLET_BIG (the DNA-Pol-1 sequences, each continued by its own start) at
# max_shift 8, whose ring (306 KB) does not fit one CTA, on route "cluster"
# (and forced onto "global").  Phase 3 holds the routes to the twin at n
# and m of these lengths (the warp's and the CTA's edges), mixed, at
# max_shift 0-4 and beyond the widths csrc/triplet.cu compiles as
# constants: "shared" and "global" on a CTA of 1024 threads and of 100 (a
# thread several rows, in a count that divides none of the row counts),
# "cluster" on clusters of TRIPLET_CLUSTERS CTAs; random, tie-heavy and
# int32-wrapping tables, each with its costs (gamma, Delta).  Route
# "cluster" is timed at TRIPLET_BIG on TRIPLET_BIG_CLUSTERS CTAs (16 where
# the card can make such a cluster resident) and at DNA-Pol-1 on
# TRIPLET_DNAPOL_CLUSTERS beside "shared"
TRIPLET_PARAMS = {k: v for k, v in DNAPOL_FULL.items()
                  if k != "gap_opening_cost"}
TRIPLET_WINDOW = 200
TRIPLET_BIG = (1500, 1490, 8)
TRIPLET_DNAPOL_SCORE = 779500    # the twin's and the oracle's
TRIPLET_FLOOR_M = 4000           # the chain probe: a pair of 0 x this
TRIPLET_STAGED_THREADS = 480     # route "shared", two rows a thread
TRIPLET_LENGTHS = (0, 1, 2, 31, 32, 33, 63, 64, 65, 1023, 1024, 1025)
TRIPLET_STATIC_SHIFTS = 8
TRIPLET_THREADS = (1024, 100)
TRIPLET_CLUSTERS = (3, 8)
TRIPLET_RESIDENT_CTAS = (None, 3)     # route "resident": its own G, and 3
TRIPLET_BIG_CLUSTERS = (2, 4, 8, 16)
# A pair that no portable cluster holds, on route "resident" through
# BiAlignerTriplet (its slabs 6.66 GB) against "global" forced; and the
# pairs at which "resident" and "cluster" are timed in turns, at the low
# end of route "cluster"'s range for max_shift 8, 4 and 1
TRIPLET_HUGE = (7000, 6990, 8)
TRIPLET_ROUTE_SHAPES = ((1100, 1090, 8), (1600, 1590, 4), (4000, 3990, 1),
                        (8400, 8390, 0), (2600, 2590, 2), (800, 790, 9),
                        (500, 490, 16))
TRIPLET_DNAPOL_CLUSTERS = (2, 4, 8)
TRIPLET_COSTS = {"random": (-200, -250), "ties": (-100, 0),
                 "wrap": (-(1 << 30) + 7, (1 << 31) - 11)}
TRIPLET_RUNS = 5                 # each route's timed runs, after a warm-up
TRIPLET_OPS_PER_CELL = 16        # int32 operations a cell: 7 adds, 7 maxes,
                                 # the sentinel's compare and select
# what an alignment stream's peak may hold beyond the band and tables of
# one dispatch: the walks' outputs of the chunks in flight, the codes, the
# LUT, the allocator's rounding (3 MB in the runs of PERF.md)
PEAK_MARGIN = 1 << 30


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


START = time.perf_counter()


def say(phase: str, **found) -> None:
    """One phase's line, with the seconds since the script started."""
    found["t_s"] = round(time.perf_counter() - START, 1)
    print(f"[{phase}] " + json.dumps(found), flush=True)


def count_tables() -> tuple:
    # an older checkout (--tile-times, --walk-times) may lack the last two
    return (cuda_dp.LAUNCHES, dtb.LAUNCHES, ckp.LAUNCHES,
            *((ssp.LAUNCHES,) if ssp else ()),
            *((trip.LAUNCHES,) if hasattr(trip, "LAUNCHES") else ()))


def counts() -> dict:
    return {k: v for table in count_tables() for k, v in table.items()}


def reset_counts() -> None:
    for table in count_tables():
        for key in table:
            table[key] = 0


def path_counts(path: str) -> dict:
    """The launch counts of one path's kernels, as they stand."""
    return {name: counts()[name] for name in PATHS[path]}


def load_golden():
    spec = importlib.util.spec_from_file_location(
        "golden", ROOT / "tests" / "golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dnapol_md5() -> dict:
    """FULL_MD5 of tests/test_dnapol.py, read without importing the test."""
    tree = ast.parse((ROOT / "tests" / "test_dnapol.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "FULL_MD5"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise RuntimeError("FULL_MD5 not found in tests/test_dnapol.py")


def rand_tables(rng, n, m, scale=100, values=(-4, 9)):
    """Random score tables in the style of tests/test_pallas.py:13-18;
    ``values=TIE_VALUES`` gives the tie-heavy ones."""
    mu1 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu2 = np.zeros((n + 1, m + 1), dtype=np.int32)
    mu1[1:, 1:] = rng.integers(*values, size=(n, m)) * scale
    mu2[1:, 1:] = rng.integers(*values, size=(n, m)) * scale
    return mu1, mu2


def cuda_ms(fn, reps: int) -> tuple[float, object]:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events on
    the current stream; returns (ms, last result)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def band_err(a, b) -> int:
    check(a.ys.shape == b.ys.shape, f"band shapes {a.ys.shape} {b.ys.shape}")
    return int((a.ys.long() - b.ys.long()).abs().max())


def row_err(a, b, n: int) -> int:
    """Max |a - b| over row n, the live row of the last diagonal's slab."""
    check(a.shape == b.shape, f"slab shapes {a.shape} {b.shape}")
    return int((a[..., n].long() - b[..., n].long()).abs().max())


def garbage_ring(rng, shape, dev):
    """A ring of arbitrary int32 values for a score-only kernel to run on:
    it must read none of them."""
    return torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)).to(dev)


def live_rows(n: int, m: int, ndim: int, dev):
    """bool ``[n+m+1, 1, ..., n+1]`` of ``ndim`` axes: the live rows of each
    diagonal of a band, the cells a band fill writes."""
    d = torch.arange(n + m + 1, device=dev)[:, None]
    i = torch.arange(n + 1, device=dev)[None, :]
    live = (i <= d) & (d - i <= m)
    return live.reshape(n + m + 1, *[1] * (ndim - 2), n + 1)


def garbage_band(shape, dev):
    """A chunk band of arbitrary int32 values, made on the card: a band-mode
    fill must write a pair's genuine cells and nothing else, and a walk must
    read only those."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                         device=dev)


def batch_band_err(a, b) -> int:
    """Max |a - b| over two chunk bands, every cell, pair by pair."""
    check(a.ys.shape == b.ys.shape, f"band shapes {a.ys.shape} {b.ys.shape}")
    return max((int((x.long() - y.long()).abs().max())
                for x, y in zip(a.ys, b.ys)), default=0)


def walks_err(out_a, out_b) -> tuple[int, int]:
    """(max |difference|, steps) of two batch walks' outputs [B, 3 + Lmax]:
    step counts, done flags, scores and the codes written."""
    a, b = (dtb.unpack_walks(o.cpu().numpy()) for o in (out_a, out_b))
    check(len(a) == len(b), f"walks of {len(a)} and {len(b)} pairs")
    e = steps = 0
    for (codes_a, done_a, score_a), (codes_b, done_b, score_b) in zip(a, b):
        check(len(codes_a) == len(codes_b),
              f"walks of {len(codes_a)} and {len(codes_b)} steps")
        diff = np.abs(codes_a.astype(np.int64) - codes_b).max(initial=0)
        e = max(e, int(diff), abs(done_a - done_b), abs(score_a - score_b))
        steps += len(codes_a)
    return e, steps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``ops`` int32 operations."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def dp_bound(n, m, S, cases: int, states: int, band: bool):
    """Bound of a fill or score over a pair: the two tables and the case
    table read once; the band (fill) or the last diagonal's slab (score)
    written once; one add and one max per (cell, shift position, state,
    case)."""
    cells, W2 = (n + 1) * (m + 1), (2 * S + 1) ** 2
    slab = states * W2 * (n + 1) * 4
    nbytes = 2 * cells * 4 + (n + m + 1 if band else 1) * slab
    return bound(nbytes, cells * W2 * states * cases * 2)


def batch_bound(lengths, S, cases: int, states: int):
    """Bound of a bucket's or a batch's scores: as dp_bound in score mode,
    summed over the pairs' genuine cells (each pair's own tables read once,
    one score written); ``lengths`` are the pairs' (n, m)."""
    cells = sum((n + 1) * (m + 1) for n, m in lengths)
    W2 = (2 * S + 1) ** 2
    return bound(2 * cells * 4 + 4 * len(lengths),
                 cells * W2 * states * cases * 2)


def band_bound(lengths, S, cases: int, states: int):
    """Bound of a bucket's or a batch's bands: as batch_bound, and every
    pair's genuine band cells written once."""
    cells = sum((n + 1) * (m + 1) for n, m in lengths)
    W2 = (2 * S + 1) ** 2
    return bound(2 * cells * 4 + cells * W2 * states * 4 + 4 * len(lengths),
                 cells * W2 * states * cases * 2)


def cells_4d(lengths, S) -> int:
    """4-D DP cells of a batch: lattice cells x shift positions."""
    return sum((n + 1) * (m + 1) for n, m in lengths) * (2 * S + 1) ** 2


def walk_bound(steps: int, cases: int):
    """Bound of a walk of ``steps`` columns (this run's trace): per step
    the cell, its cases' predecessors and the two table entries read, one
    code written; one add and one compare per case."""
    return bound(steps * ((cases + 3) * 4 + 4), steps * cases * 2)


def trace_err(ta, tb) -> int:
    check(len(ta) == len(tb), f"trace lengths {len(ta)} != {len(tb)}")
    enc = [np.asarray([8 * c[0] + 4 * c[1] + 2 * c[2] + c[3] for c in t],
                      dtype=np.int64) for t in (ta, tb)]
    return int(np.abs(enc[0] - enc[1]).max(initial=0))


def phase_kernels(dev, errs: dict) -> None:
    """Each kernel against its plain twin on random tables, at SHAPES and
    at the tile kernels' edges.  K1 and K2 in band mode fill a fresh band
    (equal to the twin's in every cell) and a band of garbage, whose cells
    off the live rows must keep the garbage."""
    beta, gamma, delta = AFFINE_PARAMS
    g2, d2 = NONAFFINE_PARAMS
    lowmem_ran = []
    for n, m, S in SHAPES + TILE_EDGE_SHAPES:
        rng = np.random.default_rng(SEED + 1000 * n + 10 * m + S)
        t1, t2 = tables_to_torch(*rand_tables(rng, n, m), dev)

        bk = cuda_dp.fill_affine_device(t1, t2, S, beta, gamma, delta)
        bp = cuda_dp.fill_affine_plain(t1, t2, S, beta, gamma, delta)
        e = max(band_err(bk, bp), garbage_band_err(
            lambda band: cuda_dp.fill_affine_device(t1, t2, S, beta, gamma,
                                                    delta, band=band), bp))
        check(e == 0, f"fill_affine band ({n}, {m}, {S}): max |err| {e}")
        check(bk.final_score() == bp.final_score(), f"affine score {n, m, S}")
        errs["fill_affine"] = max(errs["fill_affine"], e)
        affine_band = bk
        plain_bands = {True: bp}
        tk, ck = dtb.affine_traceback(bk, beta, gamma, delta, t1, t2)
        tp, cp = dtb.affine_traceback_plain(bp, beta, gamma, delta, t1, t2)
        e = trace_err(tk, tp)
        check(e == 0 and ck == cp, f"walk_affine trace ({n}, {m}, {S})")
        errs["walk_affine"] = max(errs["walk_affine"], e)
        device_walks = {True: (tk, ck)}

        bk = cuda_dp.fill_nonaffine_device(t1, t2, S, g2, d2)
        bp = cuda_dp.fill_nonaffine_plain(t1, t2, S, g2, d2)
        e = max(band_err(bk, bp), garbage_band_err(
            lambda band: cuda_dp.fill_nonaffine_device(t1, t2, S, g2, d2,
                                                       band=band), bp))
        check(e == 0, f"fill_nonaffine band ({n}, {m}, {S}): max |err| {e}")
        check(bk.final_score() == bp.final_score(),
              f"nonaffine score {n, m, S}")
        errs["fill_nonaffine"] = max(errs["fill_nonaffine"], e)
        tk = dtb.nonaffine_traceback(bk, g2, d2, t1, t2)
        tp = dtb.nonaffine_traceback_plain(bp, g2, d2, t1, t2)
        e = trace_err(tk, tp)
        check(e == 0, f"walk_nonaffine trace ({n}, {m}, {S})")
        errs["walk_nonaffine"] = max(errs["walk_nonaffine"], e)
        nonaffine_band = bk
        plain_bands[False] = bp
        device_walks[False] = tk
        lowmem_ran.append(lowmem_kernels(
            dev, errs, t1, t2, S, plain_bands, device_walks,
            edge=(n, m, S) in TILE_EDGE_SHAPES))

        # score-only: the last slab's live row against the twin's (the last
        # diagonal of its band: the ring twin runs the same step) and the
        # band kernel's, on a ring of garbage; the score on a fresh one
        W = 2 * S + 1
        sk = cuda_dp.affine_last_slab(
            t1, t2, S, beta, gamma, delta,
            ring=garbage_ring(rng, (3, 9, W, W, n + 1), dev))
        e = max(row_err(sk, plain_bands[True].ys[n + m], n),
                row_err(sk, affine_band.ys[n + m], n))
        check(e == 0, f"score_affine last slab ({n}, {m}, {S}): |err| {e}")
        errs["score_affine"] = max(errs["score_affine"], e)
        check(cuda_dp.affine_score(t1, t2, S, beta, gamma, delta)
              == affine_band.final_score(), f"score_affine score {n, m, S}")

        sk = cuda_dp.nonaffine_last_slab(
            t1, t2, S, g2, d2, ring=garbage_ring(rng, (3, W, W, n + 1), dev))
        e = max(row_err(sk, plain_bands[False].ys[n + m], n),
                row_err(sk, nonaffine_band.ys[n + m], n))
        check(e == 0, f"score_nonaffine last slab ({n}, {m}, {S}): |err| {e}")
        errs["score_nonaffine"] = max(errs["score_nonaffine"], e)
        check(cuda_dp.nonaffine_score(t1, t2, S, g2, d2)
              == nonaffine_band.final_score(),
              f"score_nonaffine score {n, m, S}")

    seconds = {"pairs": time.perf_counter() - START}
    phase_k3_kernels(dev, errs)
    seconds["k3"] = time.perf_counter() - START
    buckets = phase_batch_kernels(dev, errs)
    seconds["buckets"] = time.perf_counter() - START
    bands = phase_align_kernels(dev, errs)
    torch.cuda.synchronize()
    seconds["bands"] = time.perf_counter() - START
    ties = phase_tie_walks(dev, errs)
    seconds["tie_walks"] = time.perf_counter() - START
    split = seqsplit_kernels(errs)
    seconds["seqsplit"] = time.perf_counter() - START
    triplet = phase_triplet_kernels(dev, errs)
    seconds["triplet"] = time.perf_counter() - START
    say("3 kernels", shapes=SHAPES, tile_edge_shapes=TILE_EDGE_SHAPES,
        ms0_shapes=MS0_SHAPES + [(150, 150), (300, 257), DNAPOL_SHAPE],
        ms0_beyond_one_cta=MS0_BEYOND, k3_rings_equal_on_both_routes=True,
        bands_equal=True, garbage_bands_equal=True,
        last_slabs_equal=True, traces_equal=True,
        buckets_n_m_b_shift_form_routes_own=buckets, bucket_scores_equal=True,
        bands_n_m_b_shift_form_diagonals_steps=bands,
        bucket_bands_and_walks_equal=True,
        tie_walks_n_m_shift_form_steps=ties, tie_walks_equal=True,
        lowmem_n_m_shift_form_blocksizes_blocks_twinblocks=lowmem_ran,
        checkpoints_windows_block_walks_and_tracebacks_equal=True,
        seqsplit_n_m_shift_kind_shards=split,
        seqsplit_rings_checkpoints_windows_equal=True,
        triplet_n_m_shift_tables_routes=triplet,
        triplet_threads=TRIPLET_THREADS,
        triplet_slabs_equal_off_domain_untouched=True,
        max_abs_err=errs, t_s_at_the_end_of=seconds)


def phase_k3_kernels(dev, errs: dict) -> None:
    """K3 on its three routes forced, from the same ring of garbage: the
    ring it leaves equal to the twin's in every cell, the live states of the
    last slab equal to K1's at max_shift 0 (route "resident" at its own
    CTAs and at 3 CTAs of 32 threads, several rows a thread).  The pairs
    beyond one CTA (MS0_BEYOND, MS0_BIG): their own route is "resident",
    its ring equal to the per-diagonal route's from the same garbage and
    its last slab to K1's, and the one-CTA route refuses them."""
    beta, gamma, delta = AFFINE_PARAMS
    live = cuda_dp.ms0_live_tables(beta, gamma, delta)[0]
    forms = (("cta", "score_affine_ms0", {}),
             ("resident", "score_affine_ms0_resident", {}),
             ("resident", "score_affine_ms0_resident",
              dict(ctas=3, threads=32)),
             ("grid", "score_affine_ms0_grid", {}))
    for n, m in MS0_SHAPES + [(150, 150), (300, 257), DNAPOL_SHAPE]:
        rng = np.random.default_rng(SEED + 1000 * n + 10 * m)
        t1, t2 = tables_to_torch(*rand_tables(rng, n, m), dev)
        junk = garbage_ring(rng, (3, 3, n + 1), dev)
        twin = junk.clone()
        cuda_dp.affine_ms0_last_slab_plain(t1, t2, beta, gamma, delta,
                                           ring=twin)
        k1 = cuda_dp.affine_last_slab(t1, t2, 0, beta, gamma, delta)
        for route, name, kw in forms:
            if kw and -(-(n + 1) // kw["ctas"]) > 4 * kw["threads"]:
                continue                  # more than four rows a thread
            ring = junk.clone()
            k3 = cuda_dp.affine_ms0_last_slab(t1, t2, beta, gamma, delta,
                                              ring=ring, route=route, **kw)
            e = max(tensor_err(ring, twin), row_err(k3, k1[live, 0, 0], n))
            check(e == 0, f"{name} {kw} ring ({n}, {m}): max |err| {e}")
            errs[name] = max(errs[name], e)
        check(cuda_dp.batch_route(n, 0, True, B=1) == "cta",
              f"K3's route at n = {n}")
        check(cuda_dp.affine_score(t1, t2, 0, beta, gamma, delta)
              == int(k1[:, 0, 0, n].max()), f"score_affine_ms0 score {n, m}")

    for n, m in (MS0_BEYOND, MS0_BIG):
        rng = np.random.default_rng(SEED + n)
        t1, t2 = tables_to_torch(*rand_tables(rng, n, m), dev)
        check(cuda_dp.batch_route(n, 0, True, B=1) == "resident",
              f"K3's route at n = {n}")
        try:
            cuda_dp.affine_ms0_last_slab(t1, t2, beta, gamma, delta,
                                         route="cta")
            check(False, f"K3's one-CTA route took a pair of {n + 1} rows")
        except ValueError:
            pass
        junk = garbage_ring(rng, (3, 3, n + 1), dev)
        rings = {route: junk.clone() for route in ("resident", "grid")}
        k3 = {route: cuda_dp.affine_ms0_last_slab(
            t1, t2, beta, gamma, delta, ring=ring,
            route=None if route == "resident" else route)
            for route, ring in rings.items()}
        k1 = cuda_dp.affine_last_slab(t1, t2, 0, beta, gamma, delta)
        for route, name in (("resident", "score_affine_ms0_resident"),
                            ("grid", "score_affine_ms0_grid")):
            e = max(row_err(k3[route], k1[live, 0, 0], n),
                    tensor_err(rings[route], rings["grid"]))
            check(e == 0, f"{name} beyond one CTA ({n}, {m}): {e}")
            errs[name] = max(errs[name], e)
        del t1, t2, rings, k3, k1
    torch.cuda.synchronize()


def garbage_band_err(fill, plain) -> int:
    """Max |err| of ``fill(band)`` on a band of garbage against the twin's
    band ``plain``: its live rows, and the garbage everywhere else."""
    junk = garbage_band(tuple(plain.ys.shape), plain.ys.device)
    got = fill(junk.clone())
    live = live_rows(plain.n, plain.m, plain.ys.dim(), junk.device)
    return tensor_err(got.ys, torch.where(live, plain.ys, junk))


def lowmem_forms(affine: bool) -> tuple:
    """(fill, its twin, block fill, its twin, block walk, its twin,
    traceback, costs, the three counters) of one kind of checkpointed
    band."""
    if affine:
        return (ckp.fill_affine_checkpoint, ckp.fill_affine_checkpoint_plain,
                ckp.affine_block, ckp.affine_block_plain,
                ckp.affine_block_walk, ckp.affine_block_walk_plain,
                ckp.affine_traceback, AFFINE_PARAMS,
                ("ckpt_affine", "block_affine", "walk_affine_block"))
    return (ckp.fill_nonaffine_checkpoint, ckp.fill_nonaffine_checkpoint_plain,
            ckp.nonaffine_block, ckp.nonaffine_block_plain,
            ckp.nonaffine_block_walk, ckp.nonaffine_block_walk_plain,
            ckp.nonaffine_traceback, NONAFFINE_PARAMS,
            ("ckpt_nonaffine", "block_nonaffine", "walk_nonaffine_block"))


def tensor_err(a, b) -> int:
    """Max |a - b| over two int32 tensors of one shape, every element."""
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def window_from_band(cb, b, band, junk):
    """What block b's window must hold after its fill, from the full band
    of the plain twin: the checkpoint's two slabs (block 0: untouched), the
    live rows of the block's diagonals, and ``junk`` everywhere else."""
    want = junk.clone()
    d0 = b * cb.block
    if b:
        want[0], want[1] = cb.ckpts[b, 1], cb.ckpts[b, 0]
    i = torch.arange(cb.n + 1, device=junk.device)
    for x in range(2, want.shape[0]):
        d = d0 + x - 2
        if d > cb.n + cb.m:
            break
        live = (i <= d) & (d - i <= cb.m)
        want[x] = torch.where(live, band.ys[d], want[x])
    return want


def lowmem_kernels(dev, errs: dict, t1, t2, S, plain_bands, device_walks,
                   edge=False):
    """K9-K12 and the blockwise walks of one shape against their twins, at
    several block sizes, all memory pre-filled with garbage.  The twin fill
    runs once, at C = 1, where it saves every diagonal: the ring's contents
    do not depend on C, so the kernel's ckpts[b] at any C must equal the
    twin's ckpts[b * C] in every cell, and the last slab the twin's.  Every
    block's window must equal what the twin's full band gives it (and the
    block twin's own window, on every block of a short band and on three of
    a long one), every block walk's tensor the host walk's over that
    window, and the whole traceback the full-band device walk.  At a tile
    edge shape (``edge``) one block size, 7: K9-K12 run the tile kernel of
    K1 and K2, which the band checks there already hold at every row."""
    n, m = t1.shape[0] - 1, t1.shape[1] - 1
    D = n + m + 1
    ran = []
    for affine in (True, False):
        (fill, fill_plain, block, block_plain, walk, walk_plain, traceback,
         costs, (ckpt_name, block_name, walk_name)) = lowmem_forms(affine)
        W = 2 * S + 1
        slab = ((9,) if affine else ()) + (W, W, n + 1)
        ring = garbage_band((3, *slab), dev)
        twin = fill_plain(t1, t2, S, *costs, block=1, ring=ring.clone(),
                          ckpts=garbage_band((D, 2, *slab), dev))
        sizes = ([SMALL_BLOCKS[-1]] if edge else
                 sorted({*SMALL_BLOCKS, ckp.default_block(D), D + 4}))
        for C in sizes:
            NB = (n + m) // C + 1
            junk = garbage_band((NB, 2, *slab), dev)
            cb = fill(t1, t2, S, *costs, block=C, ring=ring.clone(),
                      ckpts=junk.clone())
            check((cb.block, cb.n_blocks) == (C, NB), f"blocks {C, NB}")
            want = junk.clone()
            want[1:] = twin.ckpts[C::C]
            e = max(tensor_err(cb.ckpts, want),
                    tensor_err(cb.final, twin.final))
            check(e == 0, f"{ckpt_name} {n, m, S} C {C}: max |err| {e}")
            errs[ckpt_name] = max(errs[ckpt_name], e)
            check(cb.final_score() == plain_bands[affine].final_score(),
                  f"{ckpt_name} {n, m, S} C {C}: score")

            walk_k, walk_p = ckp.new_walk(cb), ckp.new_walk(cb, "cpu")
            twinned = (range(NB) if D <= BLOCK_TWIN_DIAGONALS
                       else {0, NB // 2, NB - 1})
            for b in range(NB - 1, -1, -1):
                junk = garbage_band(cb.window_shape, dev)
                window = block(cb, b, window=junk.clone())
                e = tensor_err(window, window_from_band(
                    cb, b, plain_bands[affine], junk))
                if b in twinned:
                    e = max(e, tensor_err(
                        window, block_plain(cb, b, window=junk)))
                check(e == 0, f"{block_name} {n, m, S} C {C} block {b}: "
                      f"max |err| {e}")
                errs[block_name] = max(errs[block_name], e)
                walk(cb, b, window, walk_k)
                walk_plain(cb, b, window, walk_p)
                e = tensor_err(walk_k.cpu(), walk_p)
                check(e == 0, f"{walk_name} {n, m, S} C {C} block {b}: "
                      f"max |err| {e} in the walk's state and codes")
                errs[walk_name] = max(errs[walk_name], e)
            check(traceback(cb, *costs) == device_walks[affine],
                  f"blockwise traceback {n, m, S} C {C} differs from the "
                  "full-band device walk")
            ran.append([n, m, S, "affine" if affine else "nonaffine", C, NB,
                        len(twinned)])
    return ran


def mixed_lengths(rng, N, M, B):
    """(n, m) of B pairs of one (N, M) bucket: an empty first sequence, an
    empty second one, the bucket's own size and a pair far shorter than it
    first, then lengths at random."""
    fixed = [(0, M), (N, 0), (N, M), (1, 1)]
    rest = [(int(rng.integers(0, N + 1)), int(rng.integers(0, M + 1)))
            for _ in range(max(B - len(fixed), 0))]
    return (fixed + rest)[-B:]


def bucket_stacks(rng, N, M, lengths, dev, values=(-4, 9)):
    """A bucket's stacks and lengths on the card, from random tables."""
    tables = [rand_tables(rng, n, m, values=values) for n, m in lengths]
    stacks = (pbatch.stack_padded([t[0] for t in tables], N, M),
              pbatch.stack_padded([t[1] for t in tables], N, M),
              np.asarray([n for n, _m in lengths], dtype=np.int32),
              np.asarray([m for _n, m in lengths], dtype=np.int32))
    return tuple(torch.from_numpy(a).to(dev) for a in stacks)


def phase3_buckets():
    """(N, M, B, max_shift, seed, lengths of rng) of phase 3's buckets:
    BUCKETS with mixed lengths, then the buckets at the tile's edges."""
    for N, M, B, shifts in BUCKETS:
        for S in shifts:
            yield (N, M, B, S, SEED + 1000 * N + 10 * B + S,
                   functools.partial(mixed_lengths, N=N, M=M, B=B))
    for N, M, S in EDGE_BUCKETS:
        lengths = edge_lengths(N, M, S)
        yield (N, M, len(lengths), S, SEED + 1000 * N + S + 3,
               lambda rng, lengths=lengths: lengths)


def cta_rings_want(stacks, junk, ring_twin):
    """The rings [B, 3, cells, N+1] the one-CTA kernel leaves when started
    from ``junk``: pair b's ring is its own single-pair twin's
    (``ring_twin(mu1, mu2, ring)`` on the pair's own tables) run on the same
    garbage, its rows beyond n_b untouched."""
    mu1p, mu2p, ns, ms = stacks
    want = junk.clone()
    for b, (n, m) in enumerate(zip(ns.tolist(), ms.tolist())):
        own = want[b, ..., :n + 1].contiguous()
        ring_twin(mu1p[b, :n + 1, :m + 1].contiguous(),
                  mu2p[b, :n + 1, :m + 1].contiguous(), own)
        want[b, ..., :n + 1] = own
    return want


def score_err(a, b) -> int:
    check(a.shape == b.shape, f"score shapes {a.shape} {b.shape}")
    return int((a.long() - b.long()).abs().max())


def conveyor_steps(B, M, lanes, d_max) -> int:
    """Launches of one bucket on the conveyor (csrc/conveyor.cuh)."""
    return (-(-B // lanes) - 1) * cuda_dp.conveyor_T0(M) + d_max + 1


def phase_batch_kernels(dev, errs: dict) -> list:
    """K4-K8 against their plain twins on buckets of mixed lengths, on
    rings of garbage, every route forced: "cta" on every bucket that fits
    one CTA's shared memory, at CTA_THREADS threads a CTA (the rings it
    leaves equal to the single-pair twins' on small buckets), the conveyor
    on one lane, a few and one per pair."""
    beta, gamma, delta = AFFINE_PARAMS
    g2, d2 = NONAFFINE_PARAMS
    ran = []
    for N, M, B, S, seed, lengths_of in phase3_buckets():
        rng = np.random.default_rng(seed)
        W = 2 * S + 1
        stacks = bucket_stacks(rng, N, M, lengths_of(rng), dev)
        forms = (
            ("affine", cuda_dp.affine_batch_scores,
             cuda_dp.affine_batch_scores_plain,
             cuda_dp.affine_conveyor_scores_plain, (beta, gamma, delta),
             (9, W, W), "batch_affine", (
                 lambda mu1, mu2, ring: cuda_dp.affine_ms0_last_slab_plain(
                     mu1, mu2, beta, gamma, delta, ring=ring))
             if S == 0 else (
                 lambda mu1, mu2, ring: cuda_dp.affine_last_slab_plain(
                     mu1, mu2, S, beta, gamma, delta, ring=ring))),
            ("nonaffine", cuda_dp.nonaffine_batch_scores,
             cuda_dp.nonaffine_batch_scores_plain,
             cuda_dp.nonaffine_conveyor_scores_plain, (g2, d2), (W, W),
             "batch_nonaffine",
             lambda mu1, mu2, ring: cuda_dp.nonaffine_last_slab_plain(
                 mu1, mu2, S, g2, d2, ring=ring)),
        )
        for form, kern, plain, conveyor_plain, params, cells, \
                grid_name, ring_twin in forms:
            want = plain(*stacks, S, *params)
            got = kern(*stacks, S, *params, route="grid",
                       ring=garbage_ring(rng, (B, 3, *cells, N + 1), dev))
            e = score_err(got, want)
            check(e == 0, f"{grid_name} {N, M, B, S}: max |err| {e}")
            errs[grid_name] = max(errs[grid_name], e)
            routes = ["grid"]
            affine = form == "affine"

            for lanes in sorted({1, min(3, B), B}):
                routes.append(f"conveyor/{lanes}")
                belt = kern(*stacks, S, *params, route="conveyor",
                            lanes=lanes, ring=garbage_ring(
                                rng, (lanes, 3, *cells, N + 1), dev))
                e = score_err(belt, want)
                if conveyor_steps(B, M, lanes, N + M) \
                        <= CONVEYOR_TWIN_STEPS:
                    e = max(e, score_err(belt, conveyor_plain(
                        *stacks, S, *params, lanes=lanes)))
                    routes[-1] += "+twin"
                check(e == 0, f"conveyor_scores {form} {N, M, B, S} on "
                      f"{lanes} lanes: max |err| {e}")
                errs["conveyor_scores"] = max(errs["conveyor_scores"], e)

            fits = cuda_dp.cta_fits(N, S, affine)
            if fits:
                routes.append("cta")
                ms0 = affine and S == 0                     # K7
                name = "cta_scores_ms0" if ms0 else "cta_scores"
                cells = (3,) if ms0 else cells
                junk = garbage_ring(rng, (B, 3, *cells, N + 1), dev)
                rings_want = (cta_rings_want(stacks, junk, ring_twin)
                              if B <= CTA_TWIN_PAIRS else None)
                for threads in CTA_THREADS:
                    ring = junk.clone()
                    cta = kern(*stacks, S, *params, route="cta", ring=ring,
                               threads=threads)
                    e = max(score_err(cta, want), score_err(cta, got))
                    if rings_want is not None:
                        e = max(e, tensor_err(ring, rings_want))
                    check(e == 0, f"{name} {form} {N, M, B, S} on "
                          f"{threads} threads: max |err| {e}")
                    errs[name] = max(errs[name], e)
                cta = kern(*stacks, S, *params, route="cta")
                e = score_err(cta, want)
                check(e == 0, f"{name} {form} {N, M, B, S}: max |err| {e}")
                if ms0:
                    twin = cuda_dp.affine_ms0_batch_scores_plain(
                        *stacks, beta, gamma, delta)
                    check(score_err(cta, twin) == 0,
                          f"cta_scores_ms0 against its twin {N, M, B}")
            own = ("cta" if fits else "conveyor" if B >= 2 else "grid")
            check(cuda_dp.batch_route(N, S, affine, B=B) == own,
                  f"route of {N, S, B, form}")
            check(score_err(kern(*stacks, S, *params), want) == 0,
                  f"{form} {N, M, B, S} on its own route {own}")
            ran.append([N, M, B, S, form, routes, own])
    torch.cuda.synchronize()
    return ran


def align_forms(S: int) -> tuple:
    """(form, fill, its twin, the score-mode twin, walk, its twin, costs,
    a slab's cell axes, fill counter, walk counter) of K4 and K5 in band
    mode with their batch walks."""
    W = 2 * S + 1
    return (
        ("affine", cuda_dp.affine_batch_bands,
         cuda_dp.affine_batch_bands_plain, cuda_dp.affine_batch_scores_plain,
         dtb.affine_walk_batch, dtb.affine_walk_batch_plain, AFFINE_PARAMS,
         (9, W, W), "batch_fill_affine", "walk_affine_batch"),
        ("nonaffine", cuda_dp.nonaffine_batch_bands,
         cuda_dp.nonaffine_batch_bands_plain,
         cuda_dp.nonaffine_batch_scores_plain, dtb.nonaffine_walk_batch,
         dtb.nonaffine_walk_batch_plain, NONAFFINE_PARAMS, (W, W),
         "batch_fill_nonaffine", "walk_nonaffine_batch"),
    )


def phase_align_kernels(dev, errs: dict) -> list:
    """K4 and K5 in band mode and the batch walks against their plain twins
    on the buckets of mixed lengths, the bands pre-filled with garbage: the
    kernel and the twin start from the same garbage, so bands equal in
    every cell mean that only genuine cells were written; the scores are
    score mode's; the walks (kernel over the kernel's band, host walk over
    the twin's, pair by pair) give the same steps, flags, scores and codes.
    Each bucket runs to its pairs' last diagonal, as the path does, the
    small ones also to the bucket's N + M."""
    ran = []
    for N, M, B, S, seed, lengths_of in phase3_buckets():
        rng = np.random.default_rng(seed + 7)
        lengths = lengths_of(rng)
        stacks = bucket_stacks(rng, N, M, lengths, dev)
        own = max(n + m for n, m in lengths)
        for form, fill, fill_plain, scores_plain, walk, walk_plain, \
                params, cells, fill_name, walk_name in align_forms(S):
            want = scores_plain(*stacks, S, *params)
            for d_max in ((own, None) if N <= 24 else (own,)):
                D = (N + M if d_max is None else d_max) + 1
                junk = garbage_band((B, D, *cells, N + 1), dev)
                bk, sk = fill(*stacks, S, *params, d_max=d_max,
                              band=junk.clone())
                bp, sp = fill_plain(*stacks, S, *params, d_max=d_max,
                                    band=junk)
                e = max(batch_band_err(bk, bp), score_err(sk, sp),
                        score_err(sk, want))
                check(e == 0, f"{fill_name} {N, M, B, S, d_max}: "
                      f"max |err| {e}")
                errs[fill_name] = max(errs[fill_name], e)
                e, steps = walks_err(
                    walk(bk, *params, *stacks[:2]),
                    walk_plain(bp, *params, *stacks[:2]))
                check(e == 0, f"{walk_name} {N, M, B, S, d_max}: "
                      f"max |err| {e}")
                errs[walk_name] = max(errs[walk_name], e)
                ran.append([N, M, B, S, form, D, steps])
    torch.cuda.synchronize()
    return ran


def phase_tie_walks(dev, errs: dict) -> list:
    """The six walks on tie-heavy tables, each held to the host walk over
    the same device memory with max |err| 0: the single-pair walks over the
    band kernel's band; the blockwise walks block by block over the block
    kernel's windows at C = 7 and the default C, the walk tensors compared
    after every block, and the whole blockwise traceback against the
    single-pair walk; the batch walks over a bucket's band-mode fill at
    max_shift 0-3."""
    ran = []
    for n, m, S in TIE_SHAPES:
        rng = np.random.default_rng(SEED + 7000 + 1000 * n + 10 * m + S)
        t1, t2 = tables_to_torch(*rand_tables(rng, n, m, values=TIE_VALUES),
                                 dev)
        for affine in (True, False):
            (fill, _fp, block, _bp, walk, walk_plain, traceback, _costs,
             (_ckpt, _block, walk_name)) = lowmem_forms(affine)
            if affine:
                params = TIE_AFFINE_PARAMS
                band = cuda_dp.fill_affine_device(t1, t2, S, *params)
                got = dtb.affine_traceback(band, *params, t1, t2)
                want = dtb.affine_traceback_plain(band, *params, t1, t2)
                e = max(trace_err(got[0], want[0]), int(got[1] != want[1]))
                name, steps = "walk_affine", len(got[0])
            else:
                params = TIE_NONAFFINE_PARAMS
                band = cuda_dp.fill_nonaffine_device(t1, t2, S, *params)
                got = dtb.nonaffine_traceback(band, *params, t1, t2)
                want = dtb.nonaffine_traceback_plain(band, *params, t1, t2)
                e = trace_err(got, want)
                name, steps = "walk_nonaffine", len(got)
            check(e == 0, f"{name} on tie-heavy tables {n, m, S}")
            errs[name] = max(errs[name], e)
            for C in sorted({7, ckp.default_block(n + m + 1)}):
                cb = fill(t1, t2, S, *params, block=C)
                walk_k, walk_p = ckp.new_walk(cb), ckp.new_walk(cb, "cpu")
                for b in range(cb.n_blocks - 1, -1, -1):
                    window = block(cb, b)
                    walk(cb, b, window, walk_k)
                    walk_plain(cb, b, window, walk_p)
                    e = tensor_err(walk_k.cpu(), walk_p)
                    check(e == 0, f"{walk_name} on tie-heavy tables "
                          f"{n, m, S} C {C} block {b}: max |err| {e}")
                errs[walk_name] = max(errs[walk_name], e)
                check(traceback(cb, *params) == got,
                      f"blockwise traceback on tie-heavy tables {n, m, S} "
                      f"C {C} differs from the single-pair walk")
            ran.append([n, m, S, "affine" if affine else "nonaffine", steps])

    N, M, B = TIE_BUCKET
    for S in (0, 1, 2, 3):
        rng = np.random.default_rng(SEED + 7500 + S)
        lengths = mixed_lengths(rng, N, M, B)
        stacks = bucket_stacks(rng, N, M, lengths, dev, values=TIE_VALUES)
        d_max = max(n + m for n, m in lengths)
        for form, fill, _fp, _sp, walk, walk_plain, _params, _cells, _fn, \
                walk_name in align_forms(S):
            params = (TIE_AFFINE_PARAMS if form == "affine"
                      else TIE_NONAFFINE_PARAMS)
            bband, _scores = fill(*stacks, S, *params, d_max=d_max)
            e, steps = walks_err(walk(bband, *params, *stacks[:2]),
                                 walk_plain(bband, *params, *stacks[:2]))
            check(e == 0, f"{walk_name} on tie-heavy tables {N, M, B, S}: "
                  f"max |err| {e}")
            errs[walk_name] = max(errs[walk_name], e)
            ran.append([N, M, B, S, form, steps])
    torch.cuda.synchronize()
    return ran


def phase_goldens(G) -> None:
    """Goldens through BiAligner on the card, and one CLI subprocess."""
    cases = [
        ("toy_rna_affine", G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS,
         G.TOY_RNA_AFFINE_SCORE, G.TOY_RNA_AFFINE_DEFAULT_OUT),
        ("toy_rna_nonaffine", G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS,
         G.TOY_RNA_NONAFFINE_SCORE, G.TOY_RNA_NONAFFINE_DEFAULT_OUT),
        ("toy_protein_sorted", G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS,
         G.TOY_PROTEIN_SCORE, G.TOY_PROTEIN_SORTED_OUT),
    ]
    found = {}
    for name, mol, params, score, lines in cases:
        ba = BiAligner(**mol, **params)
        got = ba.optimize()
        check(got == score, f"{name} score {got} != {score}")
        check(list(ba.decode_trace()) == lines, f"{name} lines")
        # the verbose replay; non-affine, it reads band cells on the card
        last = list(ba.eval_trace())[-1]
        check(last.split(" --> ")[-1] == str(score), f"{name} eval_trace")
        found[name] = got

    seqA, strA, seqB, strB = dnapol_pair()
    ba = BiAligner(seqA[:150], seqB[:150], strA[:150], strB[:150],
                   **DNAPOL_PREFIX)
    got = ba.optimize()
    check(got == 117180, f"dnapol prefix-150 score {got} != 117180")
    last = list(ba.eval_trace())[-1]
    check(last.split(" --> ")[-1] == "117180", f"eval_trace ends {last!r}")
    found["dnapol_prefix150"] = got

    mol, p = G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS
    argv = [mol["seqA"], mol["seqB"], "--strA", mol["strA"],
            "--strB", mol["strB"],
            "--structure_weight", str(p["structure_weight"]),
            "--gap_opening_cost", str(p["gap_opening_cost"]),
            "--gap_cost", str(p["gap_cost"]),
            "--max_shift", str(p["max_shift"]),
            "--shift_cost", str(p["shift_cost"])]
    proc = subprocess.run(
        [sys.executable, "-m", "bialign_tpu_torch.cli", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    want = (["Input:"]
            + [f"{k}\t {mol[k]}" for k in ("seqA", "seqB", "strA", "strB")]
            + [f"SCORE: {G.TOY_RNA_AFFINE_SCORE}", ""]
            + G.TOY_RNA_AFFINE_DEFAULT_OUT)
    check(proc.returncode == 0,
          f"CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    check(proc.stdout.splitlines() == want,
          f"CLI stdout {proc.stdout!r}")
    found["cli_toy_rna_affine"] = "stdout equal"
    say("4 goldens", **found)


def run_e2e(mol, params, **kw):
    """One end-to-end run; returns (seconds, score, lines, aligner)."""
    seqA, strA, seqB, strB = mol
    t0 = time.perf_counter()
    ba = BiAligner(seqA, seqB, strA, strB, **params, **kw)
    score = ba.optimize()
    lines = list(ba.decode_trace())
    return time.perf_counter() - t0, score, lines, ba


def phase_full_main(mol, md5) -> dict:
    """The DNA-Pol-1 pair through the main path (counted launches)."""
    torch.cuda.reset_peak_memory_stats()
    cold, score, lines, ba = run_e2e(mol, DNAPOL_FULL)
    peak_affine = torch.cuda.max_memory_allocated()     # one run alone
    affine_band_bytes = ba._band.ys.numel() * 4
    del ba
    check(score == 761500, f"dnapol full score {score} != 761500")
    got = {line[:16].rstrip(): hashlib.md5(line[16:].encode()).hexdigest()
           for line in lines}
    check(got == md5, f"dnapol md5 anchors {got}")
    warm = [run_e2e(mol, DNAPOL_FULL)[0] for _ in range(3)]

    t_k, score_k, _lines, bak = run_e2e(mol, DNAPOL_CLI_DEFAULTS)
    trace_k = bak.traceback()
    t_p, score_p, _lines, bap = run_e2e(mol, DNAPOL_CLI_DEFAULTS,
                                        engine="torch", device="cuda")
    trace_p = bap.traceback()
    check(score_k == score_p, f"nonaffine score {score_k} != {score_p}")
    check(trace_k == trace_p, "nonaffine trace differs from the plain twin")
    return dict(
        affine_score=score, md5_anchors="all 6 equal",
        affine_e2e_cold_s=cold, affine_e2e_warm_s=warm,
        affine_band_bytes=affine_band_bytes,
        affine_max_memory_allocated=peak_affine,
        nonaffine_score=score_k, nonaffine_e2e_cuda_s=t_k,
        nonaffine_e2e_torch_s=t_p,
        nonaffine_band_bytes=bak._band.ys.numel() * 4,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
    )


@contextlib.contextmanager
def host_route():
    """BiAligner's host route on the card: the tables built on the host,
    checked and uploaded by the fill."""
    keep = pair_aligner._builds_on_device
    pair_aligner._builds_on_device = lambda device: False
    try:
        yield
    finally:
        pair_aligner._builds_on_device = keep


PAIR_TABLE_ROUNDS = 10           # each route's timed pairs, in turns


def _pair_times(mol, params) -> tuple[float, float, float]:
    """(constructor ms, the card's ms between events around the
    constructor, pair ms) of one pair, BiAligner(...) to decode_trace() as
    the CLI runs it."""
    seqA, strA, seqB, strB = mol
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    ba = BiAligner(seqA, seqB, strA, strB, **params)
    end.record()
    t1 = time.perf_counter()
    ba.optimize()
    ba.decode_trace(ba.traceback())
    t2 = time.perf_counter()
    return (t1 - t0) * 1e3, start.elapsed_time(end), (t2 - t0) * 1e3


def phase_pair_tables(mol, md5, G) -> dict:
    """The protein pair's tables built on the card from codes against the
    host tables, the goldens through that route, and both routes' times
    in turns at DNA-Pol-1."""
    seqA, strA, seqB, strB = mol
    toy = tuple(G.TOY_PROTEIN[k] for k in ("seqA", "strA", "seqB", "strB"))
    cases = (("toy_protein", toy, G.TOY_PROTEIN_PARAMS),
             ("dnapol", mol, DNAPOL_FULL),
             ("dnapol_cli_defaults", mol, DNAPOL_CLI_DEFAULTS))
    found = {}
    for name, (a, sa, b, sb), params in cases:
        ba = BiAligner(a, b, sa, sb, **params)
        check(ba._peak is not None, f"{name}: not on the device route")
        host = build_score_tables(ba.molA, ba.molB, ba._params, is_rna=False)
        check(all(np.array_equal(got, want) and got.dtype == want.dtype
                  for got, want in zip((ba.mu1, ba.mu2), host)),
              f"{name}: the card's tables differ from the host tables")
        safe = pair_codes.int32_safe(len(a), len(b), ba._peak, ba._params)
        check(safe == check_int32_safe(*host, ba._params),
              f"{name}: int32 verdict differs from the host check")
        score = ba.optimize()
        lines = list(ba.decode_trace())
        with host_route():
            hb = BiAligner(a, b, sa, sb, **params)
        check(hb._peak is None, f"{name}: host route not taken")
        check(score == hb.optimize() and lines == list(hb.decode_trace()),
              f"{name}: the routes' scores or lines differ")
        found[name] = dict(score=score, peak=ba._peak, int32_safe=safe)
    check(found["toy_protein"]["score"] == G.TOY_PROTEIN_SCORE,
          "toy protein score on the device route")
    ba = BiAligner(**G.TOY_PROTEIN, **G.TOY_PROTEIN_PARAMS)
    ba.optimize()
    check(list(ba.decode_trace()) == G.TOY_PROTEIN_SORTED_OUT,
          "toy protein lines on the device route")
    check(found["dnapol"]["score"] == 761500, "dnapol score, device route")
    _, score, lines, _ = run_e2e(mol, DNAPOL_FULL)
    check(score == 761500 and md5_anchors(lines) == md5,
          "dnapol md5 anchors on the device route")
    found["dnapol"]["md5_anchors"] = "all 6 equal"

    # both routes in turns, after one warm pair each
    _pair_times(mol, DNAPOL_FULL)
    with host_route():
        _pair_times(mol, DNAPOL_FULL)
    runs = {"device": [], "host": []}
    spans = {}
    for k in range(2 * PAIR_TABLE_ROUNDS):
        route = ("device", "host")[(k + k // 2) % 2]     # d h h d d h ...
        before = profiling.snapshot()
        with host_route() if route == "host" else contextlib.nullcontext():
            runs[route].append(_pair_times(mol, DNAPOL_FULL))
        for name, t in profiling.since(before).items():
            spans.setdefault(route, {}).setdefault(name, []).append(
                t.seconds * 1e3)
    for route, times in runs.items():
        ctor, ctor_card, pair = zip(*times)
        found[f"dnapol_{route}_route"] = dict(
            constructor_ms=float(np.median(ctor)),
            constructor_card_ms=float(np.median(ctor_card)),
            pair_ms=float(np.median(pair)), pair_ms_all=list(pair),
            span_ms={name: float(np.median(v))
                     for name, v in sorted(spans[route].items())})
    return found


def port_tables(mol, params):
    """(aligner, mu1, mu2) of the pair through the port's host layers, the
    tables on the card."""
    seqA, strA, seqB, strB = mol
    ba = BiAligner(seqA, seqB, strA, strB, **params)
    return ba, *tables_to_torch(ba.mu1, ba.mu2, "cuda")


def score_only(ba, t1, t2) -> int:
    """The pair's score through the band-free entry point of its mode."""
    if ba._affine:
        return cuda_dp.affine_score(t1, t2, ba.max_shift, ba.beta, ba.gamma,
                                    ba.delta)
    return cuda_dp.nonaffine_score(t1, t2, ba.max_shift, ba.gamma, ba.delta)


def phase_full_score(mol) -> dict:
    """The DNA-Pol-1 pair through the score-only path (counted launches):
    the port's tables, then cuda_dp.affine_score / nonaffine_score, against
    the golden score and the band path's scores."""
    found = {}
    for name, params, want in SCORED:
        ba, t1, t2 = port_tables(mol, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        score = score_only(ba, t1, t2)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()    # tables and ring alone
        band_score = ba.optimize()
        check(score == band_score,
              f"{name}: score only {score} != band path {band_score}")
        check(want is None or score == want, f"{name}: {score} != {want}")
        found[name] = dict(
            score=score, band_score=band_score, seconds=seconds,
            max_memory_allocated=peak, band_bytes=ba._band.ys.numel() * 4)

    # K3 beyond one CTA: affine_score at max_shift 0 on a pair of random
    # tables whose ring does not fit (its route "resident"), against K1's
    # score at max_shift 0 and the per-diagonal route forced
    n, m = MS0_BEYOND
    beta, gamma, delta = AFFINE_PARAMS
    t1, t2 = tables_to_torch(
        *rand_tables(np.random.default_rng(SEED + 1), n, m), "cuda")
    t0 = time.perf_counter()
    score = cuda_dp.affine_score(t1, t2, 0, beta, gamma, delta)
    seconds = time.perf_counter() - t0
    want = int(cuda_dp.affine_last_slab(t1, t2, 0, beta, gamma, delta)
               [:, 0, 0, n].max())
    grid = int(cuda_dp.affine_ms0_last_slab(t1, t2, beta, gamma, delta,
                                            route="grid")[:, n].max())
    check(score == want == grid, f"K3 beyond one CTA {n, m}: {score} "
          f"(grid forced {grid}) != K1 {want}")
    found["affine_ms0_beyond_one_cta"] = dict(
        n=n, m=m, route=cuda_dp.batch_route(n, 0, True, B=1), score=score,
        k1_score=want, grid_forced_score=grid, seconds=seconds)
    return found


def k3_beyond_times(errs: dict) -> tuple[dict, dict, dict]:
    """K3's route "resident" on the pairs beyond one CTA (MS0_BEYOND, the
    main path's, and MS0_BIG), against the per-diagonal route in turns
    (CUDA events, warm, three turns each way), both against K1 at max_shift
    0; the twin's time at MS0_BEYOND.  Returns (times, bounds, more) for
    the kernels line, at MS0_BEYOND."""
    beta, gamma, delta = AFFINE_PARAMS
    more, times, bounds = {}, {}, {}
    for n, m in (MS0_BEYOND, MS0_BIG):
        t1, t2 = tables_to_torch(
            *rand_tables(np.random.default_rng(SEED + 7 * n), n, m), "cuda")
        want = int(cuda_dp.affine_last_slab(t1, t2, 0, beta, gamma, delta)
                   [:, 0, 0, n].max())
        k3 = {route: lambda route=route: cuda_dp.affine_ms0_last_slab(
            t1, t2, beta, gamma, delta, route=route)
            for route in ("resident", "grid")}
        for route, name in (("resident", "score_affine_ms0_resident"),
                            ("grid", "score_affine_ms0_grid")):
            got = int(k3[route]()[:, n].max())           # and the warm-up
            check(got == want, f"{name} at {n, m}: {got} != K1 {want}")
        turns = {route: [] for route in k3}
        for route in ["resident", "grid", "grid", "resident"] * 3:
            turns[route].append(cuda_ms(k3[route], reps=1)[0])
        D = n + m + 1
        more[f"{n}x{m}"] = dict(
            shape=cuda_dp.ms0_resident_shape(n), turns_ms=turns,
            ms_min_max={r: (min(v), max(v)) for r, v in turns.items()},
            us_per_diagonal={r: min(v) * 1e3 / D for r, v in turns.items()})
        if (n, m) == MS0_BEYOND:
            ms_p, sp = cuda_ms(lambda: cuda_dp.affine_ms0_last_slab_plain(
                t1, t2, beta, gamma, delta), reps=1)
            e = row_err(k3["resident"](), sp, n)
            check(e == 0, f"score_affine_ms0_resident at {n, m}: |err| {e}")
            errs["score_affine_ms0_resident"] = max(
                errs["score_affine_ms0_resident"], e)
            times["score_affine_ms0_resident"] = (min(turns["resident"]),
                                                  ms_p)
            bounds["score_affine_ms0_resident"] = dp_bound(n, m, 0, 3, 3,
                                                           band=False)
            more[f"{n}x{m}"]["twin_ms"] = ms_p
        del t1, t2
    return times, bounds, more


def k3_route_times() -> dict:
    """K3's routes "cta" and "resident" in turns (CUDA events, warm, three
    turns each way) at MS0_ROUTE_SHAPES, both against K1 at max_shift 0:
    where the one-CTA route stops paying."""
    beta, gamma, delta = AFFINE_PARAMS
    found = {}
    for n, m in MS0_ROUTE_SHAPES:
        t1, t2 = tables_to_torch(
            *rand_tables(np.random.default_rng(SEED + 3 * n), n, m), "cuda")
        want = int(cuda_dp.affine_last_slab(t1, t2, 0, beta, gamma, delta)
                   [:, 0, 0, n].max())
        k3 = {route: lambda route=route: cuda_dp.affine_ms0_last_slab(
            t1, t2, beta, gamma, delta, route=route)
            for route in ("cta", "resident")}
        for route in k3:
            got = int(k3[route]()[:, n].max())           # and the warm-up
            check(got == want, f"K3 {route} at {n, m}: {got} != K1 {want}")
        turns = {route: [] for route in k3}
        for route in ["cta", "resident", "resident", "cta"] * 3:
            turns[route].append(cuda_ms(k3[route], reps=1)[0])
        found[f"{n}x{m}"] = dict(
            ms_min_max={r: (min(v), max(v)) for r, v in turns.items()},
            us_per_diagonal={r: min(v) * 1e3 / (n + m + 1)
                             for r, v in turns.items()},
            resident_shape=cuda_dp.ms0_resident_shape(n))
        del t1, t2
    return found


def phase_big_pair(dev) -> dict:
    """A 4000x3990 pair of random tables, affine max_shift 1: score-only
    against the band kernel's final score, with both times and both peak
    memories (not against the plain twin: about 8000 diagonals of
    host-bound torch ops)."""
    n, m, S = BIG_PAIR
    beta, gamma, delta = AFFINE_PARAMS
    t1, t2 = tables_to_torch(
        *rand_tables(np.random.default_rng(SEED), n, m), dev)
    runs = {
        "score_only": lambda: cuda_dp.affine_score(t1, t2, S, beta, gamma,
                                                   delta),
        "band": lambda: cuda_dp.fill_affine_device(t1, t2, S, beta, gamma,
                                                   delta).final_score(),
    }
    found = {name: dict(ms=[]) for name in runs}
    runs["score_only"]()                                      # warm-up
    for name in ("score_only", "band", "band", "score_only"):  # in turns
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms, score = cuda_ms(runs[name], reps=1)
        found[name]["ms"].append(ms)
        found[name].update(
            score=score,
            peak_bytes_above_tables=torch.cuda.max_memory_allocated() - base)
    check(found["score_only"]["score"] == found["band"]["score"],
          f"{n}x{m} scores differ: {found}")

    # K3 at max_shift 0 on the same pair: one CTA against the cooperative
    # grid and a launch a diagonal, in turns, each against K1 at max_shift 0
    k3 = {route: lambda route=route: int(cuda_dp.affine_ms0_last_slab(
        t1, t2, beta, gamma, delta, route=route)[:, n].max())
        for route in ("cta", "resident", "grid")}
    want = int(cuda_dp.affine_last_slab(t1, t2, 0, beta, gamma, delta)
               [:, 0, 0, n].max())
    ms0 = {route: dict(ms=[]) for route in k3}
    for route in k3:
        k3[route]()                                           # warm-up
    for route in [*k3, *reversed(k3)] * 2:
        ms, score = cuda_ms(k3[route], reps=1)
        check(score == want, f"K3 {route} on {n}x{m}: {score} != K1 {want}")
        ms0[route]["ms"].append(ms)
    for route, found_r in ms0.items():
        found_r["us_per_diagonal"] = min(found_r["ms"]) * 1e3 / (n + m + 1)
    return dict(n=n, m=m, max_shift=S, **found,
                k3_max_shift_0=dict(ms0, score=want))


def host_tables(mol, params):
    """(mu1, mu2, (n, m)) of one pair through the port's host layers."""
    ba = BiAligner(mol["seqA"], mol["seqB"], mol["strA"], mol["strB"],
                   **params)
    return ba.mu1, ba.mu2, (len(mol["seqA"]), len(mol["seqB"]))


def realistic_windows(mol, seed):
    """64 windows of 128-508 residues of the DNA-Pol-1 pair, the second
    within 4 residues of the first (bench.py _realistic_batched_fn and
    _mixed_corpus)."""
    seqA, strA, seqB, strB = mol
    rng = random.Random(seed)
    out = []
    for _ in range(REALISTIC_PAIRS):
        la = rng.randint(REALISTIC_LO, REALISTIC_HI)
        lb = la + rng.randint(-4, 4)
        a0 = rng.randint(0, len(seqA) - la)
        b0 = rng.randint(0, len(seqB) - lb)
        out.append(dict(seqA=seqA[a0:a0 + la], seqB=seqB[b0:b0 + lb],
                        strA=strA[a0:a0 + la], strB=strB[b0:b0 + lb]))
    return out


def timed(fn):
    """(seconds on the host clock with the device drained, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def batch_rates(tables, lengths, S, params, affine, quantum) -> tuple:
    """score_batch (tables on the host) and PreparedBatch.scores() (tables
    resident), cold then three times warm; returns (scores, report)."""
    kw = dict(affine=affine, bucket_quantum=quantum)
    torch.cuda.reset_peak_memory_stats()
    cold, scores = timed(lambda: pbatch.score_batch(tables, S, params, **kw))
    warm = [timed(lambda: pbatch.score_batch(tables, S, params, **kw))[0]
            for _ in range(3)]
    build, prep = timed(lambda: pbatch.PreparedBatch(tables, S, params, **kw))
    first, resident = timed(prep.scores)
    again = [timed(prep.scores)[0] for _ in range(3)]
    check((scores == resident).all(), "PreparedBatch differs from score_batch")
    check((pbatch.score_batch(prep, S, params, **kw) == scores).all(),
          "score_batch(PreparedBatch) differs")
    B, cells = len(tables), cells_4d(lengths, S)
    return scores, dict(
        pairs=B, cells_4d=cells, buckets=len(prep._buckets),
        score_batch_cold_s=cold, score_batch_warm_s=warm,
        score_batch_pairs_per_s=B / min(warm),
        score_batch_cells_per_s=cells / min(warm),
        prepared_build_s=build, prepared_first_s=first,
        prepared_warm_s=again, prepared_pairs_per_s=B / min(again),
        prepared_cells_per_s=cells / min(again),
        max_memory_allocated=torch.cuda.max_memory_allocated())


DNAPOL_COSTS = (DNAPOL_FULL["gap_opening_cost"], DNAPOL_FULL["gap_cost"],
                DNAPOL_FULL["shift_cost"])      # beta, gamma, delta


def realistic_batch(mol) -> tuple:
    """The 64 realistic windows as a batch: (tables, lengths, max_shift,
    costs, affine, bucket quantum)."""
    pairs = [host_tables(w, DNAPOL_FULL) for w in realistic_windows(mol, SEED)]
    return ([p[:2] for p in pairs], [p[2] for p in pairs], 1, DNAPOL_COSTS,
            True, REALISTIC_QUANTUM)


def toy_batch() -> tuple:
    """512 copies of the toy protein pair in one 64 x 64 bucket, as
    realistic_batch."""
    mu1, mu2, nm = host_tables(TOY, DNAPOL_FULL)
    return ([(mu1, mu2)] * TOY_PAIRS, [nm] * TOY_PAIRS, 1, DNAPOL_COSTS, True,
            64)


def phase_batch_main(mol) -> tuple[dict, dict]:
    """The batched-scores path through score_batch and PreparedBatch
    (counted launches); returns (report, the batches for the timing)."""
    costs = DNAPOL_COSTS
    found, batches = {}, {}

    # realistic: buckets of 129-513 rows and 17-28 pairs, so K8
    batches["realistic"] = realistic_batch(mol)
    tables, lengths = batches["realistic"][:2]
    scores, report = batch_rates(tables, lengths, 1, costs, True,
                                 REALISTIC_QUANTUM)
    check(scores.dtype == np.int64 and scores.shape == (REALISTIC_PAIRS,),
          f"realistic scores {scores.dtype} {scores.shape}")
    t0 = time.perf_counter()
    singly = [cuda_dp.affine_score(*tables_to_torch(mu1, mu2, "cuda"), 1,
                                   *costs) for mu1, mu2 in tables]
    report["one_at_a_time_affine_score_s"] = time.perf_counter() - t0
    check(scores.tolist() == singly,
          f"realistic batch {scores.tolist()} != affine_score {singly}")
    report.update(lengths=lengths, scores_equal_affine_score=True)
    found["realistic"] = report

    # toy b512: K6 (affine), K7 (max_shift 0), K6 non-affine
    batches["toy_b512"] = toy_batch()
    tables, lengths = batches["toy_b512"][:2]
    scores, report = batch_rates(tables, lengths, 1, costs, True, 64)
    check((scores == TOY_SCORE).all() and scores.shape == (TOY_PAIRS,),
          f"toy b512 scores {np.unique(scores)}")
    found["toy_b512"] = dict(report, all_scores=TOY_SCORE)

    t1, t2 = tables_to_torch(*tables[0], "cuda")
    want0 = cuda_dp.affine_score(t1, t2, 0, *costs)
    scores, report = batch_rates(tables, lengths, 0, costs, True, 64)
    check((scores == want0).all(), f"toy b512 ms0 {np.unique(scores)}")
    found["toy_b512_ms0"] = dict(report, all_scores=want0)
    batches["toy_b512_ms0"] = (tables, lengths, 0, costs, True, 64)

    ba = BiAligner(**TOY, **DNAPOL_CLI_DEFAULTS)        # non-affine
    check(not ba._affine, "the CLI defaults are non-affine")
    S, na = ba.max_shift, (ba.gamma, ba.delta)
    tables = [(ba.mu1, ba.mu2)] * TOY_PAIRS
    t1, t2 = tables_to_torch(ba.mu1, ba.mu2, "cuda")
    want_na = cuda_dp.nonaffine_score(t1, t2, S, *na)
    scores, report = batch_rates(tables, lengths, S, na, False, 64)
    check((scores == want_na).all(),
          f"toy b512 non-affine {np.unique(scores)}")
    found["toy_b512_nonaffine"] = dict(report, all_scores=want_na)
    batches["toy_b512_nonaffine"] = (tables, lengths, S, na, False, 64)

    # the whole DNA-Pol-1 pair, non-affine, four copies: a bucket of 1025
    # rows, beyond one CTA's shared memory, so K8 in its non-affine form;
    # and a batch of that one pair, which K5 takes
    seqA, strA, seqB, strB = mol
    full = dict(seqA=seqA, seqB=seqB, strA=strA, strB=strB)
    mu1, mu2, nm = host_tables(full, DNAPOL_CLI_DEFAULTS)
    tables, lengths = [(mu1, mu2)] * FULL_COPIES, [nm] * FULL_COPIES
    want = cuda_dp.nonaffine_score(*tables_to_torch(mu1, mu2, "cuda"), S, *na)
    scores, report = batch_rates(tables, lengths, S, na, False,
                                 REALISTIC_QUANTUM)
    check((scores == want).all(), f"DNA-Pol non-affine {scores} != {want}")
    found["dnapol_nonaffine_x4"] = dict(report, all_scores=want)
    batches["dnapol_nonaffine_x4"] = (tables, lengths, S, na, False,
                                      REALISTIC_QUANTUM)
    scores, report = batch_rates(tables[:1], lengths[:1], S, na, False,
                                 REALISTIC_QUANTUM)
    check(scores.tolist() == [want], f"DNA-Pol non-affine {scores} != {want}")
    found["dnapol_nonaffine_x1"] = dict(report, all_scores=want)

    # the same pair, affine, as a batch of one: K4, and the golden score
    mu1, mu2, nm = host_tables(full, DNAPOL_FULL)
    scores, report = batch_rates([(mu1, mu2)], [nm], 1, costs, True,
                                 REALISTIC_QUANTUM)
    check(scores.tolist() == [761500], f"DNA-Pol affine batch of one {scores}")
    found["dnapol_affine_x1"] = dict(report, all_scores=761500)
    return found, batches


# kernel of the kernels line -> (batch of phase_batch_main, the route to
# force or None for the path's own, cases, states)
BATCH_TIMED = {"conveyor_scores": ("realistic", None, 15, 9),
               "batch_affine": ("realistic", "grid", 15, 9),
               "cta_scores": ("toy_b512", None, 15, 9),
               "cta_scores_ms0": ("toy_b512_ms0", None, 3, 3),
               "batch_nonaffine": ("dnapol_nonaffine_x4", "grid", 13, 1)}
# the second form of a kernel on the main path's shape, or a kernel on
# another batch, held to its twin and timed like the first: name in the
# report -> (kernel, batch, route, cases, states)
BATCH_TIMED_FORMS = {
    "cta_scores_nonaffine": ("cta_scores", "toy_b512_nonaffine", None, 13, 1),
    "conveyor_scores_nonaffine": ("conveyor_scores", "dnapol_nonaffine_x4",
                                  None, 13, 1),
    "batch_nonaffine_realistic": ("batch_nonaffine", "realistic_nonaffine",
                                  "grid", 13, 1),
    "conveyor_scores_nonaffine_realistic": (
        "conveyor_scores", "realistic_nonaffine", "conveyor", 13, 1)}


def routed(batch, route=None, lanes_of=None):
    """(dispatch, buckets) of one batch of phase_batch_main with its tables
    resident: ``dispatch()`` queues every bucket on ``route`` (None: the
    path's own), the conveyor on ``lanes_of(B)`` lanes (None: its own), and
    returns the PendingScores."""
    tables, _lengths, S, params, affine, quantum = batch
    buckets = pbatch._device_buckets(tables, quantum, torch.device("cuda"))
    kern = (cuda_dp.affine_batch_scores if affine
            else cuda_dp.nonaffine_batch_scores)

    def dispatch():
        return pbatch.PendingScores(len(tables), [
            (idx, kern(*st, S, *params, route=route, d_max=d_max,
                       lanes=lanes_of and lanes_of(st[0].shape[0])))
            for idx, st, d_max in buckets])
    return dispatch, buckets


def phase_batch_timing(batches, errs: dict) -> tuple[dict, dict, dict]:
    """The bucket kernels against their plain twins on the batches of the
    main path (not counted): every bucket's launches with the tables
    resident, CUDA events around all of them; the twins through
    engine="torch" on the card.  Returns (times, bounds, more)."""
    times, bounds, more, twins = {}, {}, {}, {}
    # the realistic windows' tables under the non-affine CLI defaults' costs
    realistic, nonaffine = batches["realistic"], batches["dnapol_nonaffine_x4"]
    batches = dict(batches, realistic_nonaffine=(
        *realistic[:2], *nonaffine[2:4], False, realistic[5]))
    timed = {name: (name, *spec) for name, spec in BATCH_TIMED.items()}
    timed.update(BATCH_TIMED_FORMS)
    for label, (name, batch, route, cases, states) in timed.items():
        tables, lengths, S, params, affine, quantum = batches[batch]
        dispatch, buckets = routed(batches[batch], route)
        before = counts()[name]
        dispatch()                                            # warm-up
        per_call = counts()[name] - before
        check(per_call == len(buckets),
              f"{batch} ran {per_call} launches of {name}")
        ms_k, pending = cuda_ms(dispatch, reps=5)
        if batch not in twins:
            twin = pbatch.PreparedBatch(tables, S, params, engine="torch",
                                        affine=affine, bucket_quantum=quantum)
            ms_p, plain = cuda_ms(twin.dispatch, reps=1)
            twins[batch] = (ms_p, plain.get())
        ms_p, plain = twins[batch]
        e = int(np.abs(pending.get() - plain).max())
        check(e == 0, f"{label} on {batch}: max |err| {e} against the twin")
        errs[name] = max(errs[name], e)
        launches = {
            "batch": sum(d_max + 1 for _i, _st, d_max in buckets),
            "conve": sum(conveyor_steps(
                st[0].shape[0], st[0].shape[2] - 1,
                cuda_dp.conveyor_lanes(st[0].shape[0], st[0].shape[1] - 1,
                                       S, affine),
                d_max) for _i, st, d_max in buckets),
            "cta_s": per_call}[name[:5]]
        found = dict(batch=batch, wrapper_calls_per_run=per_call,
                     kernel_launches_per_run=launches,
                     us_per_launch=ms_k * 1e3 / launches)
        if label == name:
            times[name] = (ms_k, ms_p)
            bounds[name] = batch_bound(lengths, S, cases, states)
            more[name] = found
        else:
            b_ms, b_by = batch_bound(lengths, S, cases, states)
            more[label] = dict(found, kernel_ms=ms_k, plain_ms=ms_p,
                               bound_ms=b_ms, bound_by=b_by, max_abs_err=e)

    # the routes against each other on the same buckets, in turns
    for batch, routes in (("toy_b512", ("cta", "grid", "conveyor")),
                          ("toy_b512_nonaffine", ("cta", "grid", "conveyor")),
                          ("realistic", ("conveyor", "grid")),
                          ("dnapol_nonaffine_x4", ("conveyor", "grid"))):
        runs = {r: routed(batches[batch], r)[0] for r in routes}
        found = {r: [] for r in routes}
        want = runs[routes[0]]().get()                        # warm-up
        for route in (*routes, *reversed(routes)):
            runs[route]()
            ms, pending = cuda_ms(runs[route], reps=3)
            found[route].append(ms)
            check((pending.get() == want).all(),
                  f"{batch}: {route} != {routes[0]}")
        more[f"{batch}_routes_ms"] = found

    # the conveyor's lanes on the realistic buckets: its own choice
    # (conveyor_lanes), a lane per pair, half, a quarter and one lane for
    # the bucket
    want = routed(batches["realistic"])[0]().get()
    lanes_ms = {}
    for share in ("own", 1, 2, 4, None):
        lanes_of = {"own": None, None: lambda B: 1}.get(
            share, lambda B, share=share: -(-B // share))
        run, buckets = routed(batches["realistic"], "conveyor", lanes_of)
        run()
        ms, pending = cuda_ms(run, reps=1)
        check((pending.get() == want).all(), f"conveyor on {share} lanes")
        lanes = [lanes_of(st[0].shape[0]) if lanes_of else
                 cuda_dp.conveyor_lanes(st[0].shape[0], st[0].shape[1] - 1,
                                        1, True) for _i, st, _d in buckets]
        key = {"own": "own", None: "1"}.get(share, f"B/{share}")
        lanes_ms[key] = dict(ms=ms, lanes=lanes, launches=sum(
            conveyor_steps(st[0].shape[0], st[0].shape[2] - 1, k, d_max)
            for (_i, st, d_max), k in zip(buckets, lanes)))
    more["conveyor_lanes_realistic"] = lanes_ms

    # K6 alone on 1 pair, then one, three and four CTAs per SM's worth of
    # pairs: a CTA's microseconds per diagonal with the carry in shared
    # memory, and how the pairs of a bucket share the card
    tables, lengths, S, params, _affine, quantum = batches["toy_b512"]
    (_idx, stacks, _d_max), = pbatch._device_buckets(tables, quantum,
                                                     torch.device("cuda"))
    diagonals = sum(lengths[0]) + 1
    scaling = {}
    for B in (1, 132, 396, 512):
        part = tuple(t[:B].contiguous() for t in stacks)
        run = lambda: cuda_dp.affine_batch_scores(  # noqa: E731
            *part, S, *params, route="cta")
        run()
        ms, got = cuda_ms(run, reps=5)
        check(bool((got == TOY_SCORE).all()), f"K6 on {B} toy pairs")
        scaling[B] = dict(ms=ms, us_per_diagonal=ms * 1e3 / diagonals)
    more["cta_scores_pairs_ms"] = scaling

    # K6's threads a CTA on the toy bucket, both forms, in turns
    sweep = {}
    for batch in ("toy_b512", "toy_b512_nonaffine"):
        tables, lengths, S, params, affine, quantum = batches[batch]
        (_idx, stacks, _d_max), = pbatch._device_buckets(
            tables, quantum, torch.device("cuda"))
        kern = (cuda_dp.affine_batch_scores if affine
                else cuda_dp.nonaffine_batch_scores)
        runs = {threads: lambda threads=threads: kern(
            *stacks, S, *params, route="cta", threads=threads)
            for threads in CTA_SWEEP}
        want = runs[CTA_SWEEP[0]]()                           # warm-up
        found = {threads: [] for threads in CTA_SWEEP}
        for threads in (*CTA_SWEEP, *reversed(CTA_SWEEP)):
            runs[threads]()
            ms, got = cuda_ms(runs[threads], reps=3)
            check(bool((got == want).all()), f"K6 on {threads} threads")
            found[threads].append(ms)
        sweep[batch] = found
    more["cta_scores_threads_ms"] = sweep
    return times, bounds, more


def single_alignments(windows, params) -> tuple:
    """The pairs one at a time through BiAligner on the card (tables, band
    fill, score, device walk, each pair waited for): (scores, traces,
    complete flags, seconds by stage)."""
    scores, traces, complete = [], [], []
    clock = time.perf_counter
    spent = dict(tables_s=0.0, fill_and_score_s=0.0, walk_s=0.0)
    for w in windows:
        t = [clock()]
        ba = BiAligner(**w, **params)
        t.append(clock())
        scores.append(ba.optimize())
        t.append(clock())
        if ba._affine:
            trace, whole = dtb.affine_traceback(
                ba._band, ba.beta, ba.gamma, ba.delta, ba._mu1_t, ba._mu2_t)
        else:
            trace, whole = ba.traceback(), True
        t.append(clock())
        traces.append(trace)
        complete.append(whole)
        for key, dt in zip(spent, np.diff(t)):
            spent[key] += float(dt)
    return scores, traces, complete, spent


def align_rates(run, pairs: int) -> tuple:
    """``run()`` cold, then three times warm, on the host clock with the
    device drained; returns (its result, report)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cold, out = timed(run)
    warm = [timed(run)[0] for _ in range(3)]
    return out, dict(pairs=pairs, cold_s=cold, warm_s=warm,
                     alignments_per_s=pairs / min(warm),
                     max_memory_allocated=torch.cuda.max_memory_allocated())


def check_alignments(got, want, what: str) -> None:
    """(scores, traces, complete) of two runs, equal pair by pair."""
    check(np.asarray(got[0]).tolist() == np.asarray(want[0]).tolist(),
          f"{what}: scores differ")
    check(list(got[2]) == list(want[2]), f"{what}: complete flags differ")
    check(len(got[1]) == len(want[1]), f"{what}: {len(got[1])} traces")
    for idx, (ta, tb) in enumerate(zip(got[1], want[1])):
        check(ta == tb, f"{what}: trace of pair {idx} differs")


def md5_anchors(lines) -> dict:
    return {line[:16].rstrip(): hashlib.md5(line[16:].encode()).hexdigest()
            for line in lines}


def upload_bytes(buckets, stack_bytes) -> int:
    """Bytes a batch's buckets send to the card: ``stack_bytes(bucket)`` for
    its stacks and the two int32 length vectors."""
    return sum(stack_bytes(b) + 2 * 4 * len(b.indices)
               for b in buckets.values())


def realistic_dispatchers(mol, batch) -> dict:
    """The 64 windows' alignments, dispatched from their tables and from
    their raw sequences (the codes path, the similarity table resident on
    the card): name -> a function that returns the pending alignments."""
    windows = realistic_windows(mol, SEED)
    tables, _lengths, S, costs, affine, quantum = batch
    lut = torch.from_numpy(_sim_lut(DNAPOL_FULL["simmatrix"])[0]).to("cuda")
    ckw = dict(affine=affine, bucket_quantum=quantum, lut=lut,
               structure_weight=DNAPOL_FULL["structure_weight"])
    return {
        "realistic_tables": functools.partial(
            pbatch.dispatch_align_batch, tables, S, costs, affine=affine,
            bucket_quantum=quantum),
        "realistic_codes": lambda: pbatch.dispatch_align_batch_codes(
            [pbatch.encode_pair(w["seqA"], w["seqB"], w["strA"], w["strB"])
             for w in windows], S, costs, **ckw)}


def align_realistic(mol, batch) -> dict:
    """The 64 windows through align_batch, against affine_score and the
    single-pair path, at the card's band budget and at a smaller one; then
    from their raw sequences through the codes path, against the tables
    path."""
    found = {}
    windows = realistic_windows(mol, SEED)
    tables, _lengths, S, costs, affine, quantum = batch
    kw = dict(affine=affine, bucket_quantum=quantum)
    dispatchers = realistic_dispatchers(mol, batch)
    from_tables = dispatchers["realistic_tables"]
    aligned, report = align_rates(lambda: from_tables().get(), len(tables))
    scores, traces, complete = aligned
    check(scores.dtype == np.int64 and scores.shape == (REALISTIC_PAIRS,),
          f"aligned scores {scores.dtype} {scores.shape}")
    singly = [cuda_dp.affine_score(*tables_to_torch(mu1, mu2, "cuda"), S,
                                   *costs) for mu1, mu2 in tables]
    check(scores.tolist() == singly,
          f"align_batch scores {scores.tolist()} != affine_score {singly}")
    t0 = time.perf_counter()
    *single, spent = single_alignments(windows, DNAPOL_FULL)
    one_at_a_time = time.perf_counter() - t0
    check_alignments(aligned, single, "align_batch against BiAligner")
    t0 = time.perf_counter()
    pending = from_tables()
    dispatch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    report.update(
        band_budget=pbatch.BAND_BUDGET, dispatches=pending.n_dispatches,
        dispatch_returns_after_s=dispatch_s,
        one_at_a_time_s=one_at_a_time, one_at_a_time_stages=spent,
        one_at_a_time_alignments_per_s=len(tables) / one_at_a_time,
        columns=sum(len(t) for t in traces),
        incomplete=complete.count(False),
        scores_equal_affine_score=True, equal_to_single_pair_path=True,
        host_to_device_bytes=upload_bytes(
            pbatch.make_buckets_dense(tables, quantum),
            lambda b: 2 * len(b.indices) * (b.N + 1) * (b.M + 1) * 4))
    found["realistic"] = report

    # the same at the band budget of the JAX package's chunks
    kept, pbatch.BAND_BUDGET = pbatch.BAND_BUDGET, TPU_SIZED_BUDGET
    try:
        again, report = align_rates(lambda: from_tables().get(), len(tables))
        report.update(band_budget=pbatch.BAND_BUDGET,
                      dispatches=from_tables().n_dispatches)
    finally:
        pbatch.BAND_BUDGET = kept
    check_alignments(again, aligned, "align_batch at the smaller budget")
    found["realistic_2GiB_budget"] = report

    # the codes path: the same windows from their raw sequences, the
    # similarity table resident on the card
    lut = torch.from_numpy(_sim_lut(DNAPOL_FULL["simmatrix"])[0]).to("cuda")
    ckw = dict(kw, lut=lut, structure_weight=DNAPOL_FULL["structure_weight"])

    def encoded():
        return [pbatch.encode_pair(w["seqA"], w["seqB"], w["strA"], w["strB"])
                for w in windows]

    coded_scores, report = align_rates(
        lambda: pbatch.dispatch_score_batch_codes(encoded(), S, costs,
                                                  **ckw).get(), len(windows))
    check(coded_scores.tolist() == scores.tolist(),
          "dispatch_score_batch_codes differs from the tables path")
    found["realistic_codes_scores"] = dict(
        report, pairs_per_s=report["alignments_per_s"],
        equal_to_tables_path=True)
    from_codes = dispatchers["realistic_codes"]
    coded, report = align_rates(lambda: from_codes().get(), len(windows))
    check_alignments(coded, aligned, "dispatch_align_batch_codes against "
                     "the tables path")
    found["realistic_codes"] = dict(
        report, dispatches=from_codes().n_dispatches,
        equal_to_tables_path=True, lut_resident=True,
        host_to_device_bytes=upload_bytes(
            pbatch._code_buckets(encoded(), quantum),
            lambda b: sum(a.nbytes for a in b.mu1d)))
    return found


def phase_align_main(mol, batches, md5, G) -> dict:
    """The batched-alignments path through align_batch and the codes path
    through dispatch_score_batch_codes and dispatch_align_batch_codes
    (counted launches)."""
    found = align_realistic(mol, batches["realistic"])
    seqA, strA, seqB, strB = mol
    full = dict(seqA=seqA, seqB=seqB, strA=strA, strB=strB)

    # 512 toy pairs: the golden score and lines
    tables, _lengths, S, costs, affine, quantum = batches["toy_b512"]
    aligned, report = align_rates(
        lambda: pbatch.align_batch(tables, S, costs, affine=affine,
                                   bucket_quantum=quantum), TOY_PAIRS)
    scores, traces, complete = aligned
    check((scores == TOY_SCORE).all() and scores.shape == (TOY_PAIRS,),
          f"toy b512 aligned scores {np.unique(scores)}")
    check(all(complete) and all(t == traces[0] for t in traces),
          "toy b512 traces differ from one another")
    ba = BiAligner(**TOY, **G.TOY_PROTEIN_PARAMS)
    check(list(ba.decode_trace(traces[0])) == G.TOY_PROTEIN_SORTED_OUT,
          "toy b512 golden lines")
    found["toy_b512"] = dict(report, all_scores=TOY_SCORE,
                             golden_lines="equal")

    # the whole DNA-Pol-1 pair as a batch of one: the golden gate
    mu1, mu2, _nm = host_tables(full, DNAPOL_FULL)
    aligned, report = align_rates(
        lambda: pbatch.align_batch([(mu1, mu2)], 1, costs, affine=True,
                                   bucket_quantum=REALISTIC_QUANTUM), 1)
    scores, traces, complete = aligned
    check(scores.tolist() == [761500] and complete == [True],
          f"DNA-Pol-1 batch of one {scores} {complete}")
    ba = BiAligner(seqA, seqB, strA, strB, **DNAPOL_FULL)
    got = md5_anchors(ba.decode_trace(traces[0]))
    check(got == md5, f"DNA-Pol-1 batch of one md5 anchors {got}")
    found["dnapol_affine_x1"] = dict(report, all_scores=761500,
                                     md5_anchors="all 6 equal")

    # four DNA-Pol-1 pairs, non-affine, against the single pair
    tables, _lengths, S, na, affine, quantum = batches["dnapol_nonaffine_x4"]
    aligned, report = align_rates(
        lambda: pbatch.align_batch(tables, S, na, affine=affine,
                                   bucket_quantum=quantum), FULL_COPIES)
    ba = BiAligner(seqA, seqB, strA, strB, **DNAPOL_CLI_DEFAULTS)
    want = ba.optimize()
    check(want == 288000, f"DNA-Pol-1 non-affine score {want} != 288000")
    check_alignments(aligned, ([want] * FULL_COPIES,
                               [ba.traceback()] * FULL_COPIES,
                               [True] * FULL_COPIES),
                     "DNA-Pol-1 non-affine x4 against the single pair")
    found["dnapol_nonaffine_x4"] = dict(report, all_scores=want,
                                        equal_to_single_pair_path=True)

    # max_shift 3: through BiAligner and as a batch of two
    for name, (molecule, score, lines) in MS3_GOLDENS.items():
        ba = BiAligner(**molecule, **MS3_PARAMS)
        check(ba.optimize() == score and list(ba.decode_trace()) == lines,
              f"max_shift 3 golden {name} through BiAligner")
        scores, traces, complete = pbatch.align_batch(
            [(ba.mu1, ba.mu2)] * 2, 3, (ba.beta, ba.gamma, ba.delta),
            affine=True)
        check(scores.tolist() == [score] * 2 and complete == [True] * 2
              and all(list(ba.decode_trace(t)) == lines for t in traces),
              f"max_shift 3 golden {name} through align_batch")
        found[f"max_shift_3_{name}"] = score
    return found


LOWMEM_GOLDEN_BLOCKS = (2, 7)    # many block edges under a short trace


def replay_affine(trace, mu1, mu2, beta, gamma, delta) -> tuple:
    """An affine trace's score summed column by column on the host, as
    BiAligner._eval_affine_trace does, and where its columns end."""
    total, state, idx = 0, [1, 1, 1, 1], [0, 0, 0, 0]
    for y in trace:
        idx = [a + b for a, b in zip(idx, y)]
        i, j, k, l = idx
        mu1c, mu2c, ng, nb, nd = affine_score_multiplicities(state, y)
        total += (ng * gamma + nb * beta + nd * delta
                  + mu1c * int(mu1[i, j]) + mu2c * int(mu2[k, l]))
        state = [*(y[:2] if y[0] or y[1] else state[:2]),
                 *(y[2:] if y[2] or y[3] else state[2:])]
    return total, tuple(idx)


# a device sleep (cycles, about 1 ms) between a block's fill and its walk,
# longer than the host takes to queue the walk (a whole traceback's
# launches do not fit the stream's queue ahead of one long sleep)
HEAD_START_CYCLES = 2_000_000


def timed_traceback(cb, head_start: int = 0) -> tuple:
    """The blockwise traceback of ``cb`` as checkpoint_dp._traceback queues
    it, with CUDA events around every block's fill and every block's walk
    (nothing is waited for until the last).  With ``head_start`` cycles of
    device sleep after every block's fill, the walks' events hold the
    device's time for the walks, not its waits for the host.  Returns
    (trace or (trace, complete), ms of all block fills, ms of all block
    walks, seconds on the host clock with the one copy back, whether the
    host had queued every walk before the device reached it)."""
    (_fill, _fp, block, _bp, walk_fn, _wp, _tb, _costs, _names) = \
        lowmem_forms(cb.affine)
    marks, behind = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk, window = ckp.new_walk(cb), None
    for b in range(cb.n_blocks - 1, -1, -1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        window = block(cb, b, window=window)
        ev[1].record()
        if head_start:
            torch.cuda._sleep(head_start)
        ev[2].record()
        walk_fn(cb, b, window, walk)
        ev[3].record()
        behind += ev[2].query()
        marks.append(ev)
    res = walk.cpu().numpy()
    seconds = time.perf_counter() - t0
    steps, done = int(res[ckp.STATE]), int(res[ckp.STATE + 1])
    codes = res[ckp.STATE + 3:ckp.STATE + 3 + steps]
    result = (ckp._affine_result if cb.affine else ckp._nonaffine_result)(
        codes, done, res[:ckp.STATE])
    return (result, sum(ev[0].elapsed_time(ev[1]) for ev in marks),
            sum(ev[2].elapsed_time(ev[3]) for ev in marks), seconds,
            behind == 0)


def lowmem_stages(fill, what: str) -> tuple:
    """One checkpointed fill and its timed traceback, with the peak device
    memory above what was allocated before: (band, result, report)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fill_ms, cb = cuda_ms(fill, reps=1)
    result, blocks_ms, walks_ms, seconds, _ahead = timed_traceback(cb)
    launches = cb.n + cb.m + 1
    return cb, result, dict(
        what=what, block=cb.block, blocks=cb.n_blocks,
        checkpoint_bytes=cb.ckpts.numel() * 4,
        window_bytes=int(np.prod(cb.window_shape)) * 4,
        ckpt_fill_ms=fill_ms, ckpt_us_per_launch=fill_ms * 1e3 / launches,
        block_fills_ms=blocks_ms,
        block_us_per_launch=blocks_ms * 1e3 / launches,
        block_walks_ms=walks_ms, traceback_s=seconds,
        peak_bytes_above_tables=torch.cuda.max_memory_allocated() - base)


def lowmem_dnapol(mol, md5) -> dict:
    """The DNA-Pol-1 pair through BiAligner(lowmem=True): the golden score
    and md5 anchors at affine max_shift 1, and there, at max_shift 2 and at
    the non-affine CLI defaults the band path's score and trace; end-to-end
    times and peak memory of both paths."""
    found = {}
    for name, params, want in (
            ("affine_ms1", DNAPOL_FULL, 761500),
            ("affine_ms2", dict(DNAPOL_FULL, max_shift=2), 768650),
            ("nonaffine_ms2_cli_defaults", DNAPOL_CLI_DEFAULTS, 288000)):
        runs = {}
        for path, kw in (("lowmem", dict(lowmem=True)), ("band", {})):
            run_e2e(mol, params, **kw)                        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seconds, score, lines, ba = run_e2e(mol, params, **kw)
            trace = ba.traceback()
            del ba                          # one run's memory at a time
            runs[path] = dict(
                score=score,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                e2e_s=[seconds] + [run_e2e(mol, params, **kw)[0]
                                   for _ in range(2)],
                alignment=(score, trace, lines))
        low, band = (runs[k].pop("alignment") for k in ("lowmem", "band"))
        check(low[0] == want, f"lowmem {name}: score {low[0]} != {want}")
        check(low == band, f"lowmem {name}: score, trace or lines differ "
              "from the band path's")
        if name == "affine_ms1":
            check(md5_anchors(low[2]) == md5, "lowmem md5 anchors")
            runs["md5_anchors"] = "all 6 equal"
        runs["columns"] = len(low[1])
        runs["equal_to_band_path"] = True
        found[name] = runs
    return found


def lowmem_goldens(G) -> dict:
    """The toy goldens and the max_shift 3 goldens through
    BiAligner(lowmem=True) at small block sizes, the verbose replay (which
    reads a non-affine band's cells block by block) and one --lowmem CLI
    run in a subprocess."""
    found = {}
    cases = [
        ("toy_rna_affine", G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS,
         G.TOY_RNA_AFFINE_SCORE, G.TOY_RNA_AFFINE_DEFAULT_OUT),
        ("toy_rna_nonaffine", G.TOY_RNA, G.TOY_RNA_NONAFFINE_PARAMS,
         G.TOY_RNA_NONAFFINE_SCORE, G.TOY_RNA_NONAFFINE_DEFAULT_OUT),
        ("toy_protein_sorted", G.TOY_PROTEIN, G.TOY_PROTEIN_PARAMS,
         G.TOY_PROTEIN_SCORE, G.TOY_PROTEIN_SORTED_OUT),
    ] + [(f"max_shift_3_{name}", mol, MS3_PARAMS, score, lines)
         for name, (mol, score, lines) in MS3_GOLDENS.items()]
    for name, mol, params, score, lines in cases:
        want = list(BiAligner(**mol, **params).eval_trace())
        for block in (None, *LOWMEM_GOLDEN_BLOCKS):
            ba = BiAligner(**mol, **params, lowmem=True,
                           checkpoint_block=block)
            check(ba.optimize() == score and list(ba.decode_trace()) == lines,
                  f"lowmem golden {name} at block {block}")
            check(list(ba.eval_trace()) == want,
                  f"lowmem golden {name} at block {block}: eval_trace")
        found[name] = score

    mol, p = G.TOY_RNA, G.TOY_RNA_AFFINE_PARAMS
    argv = [mol["seqA"], mol["seqB"], "--strA", mol["strA"],
            "--strB", mol["strB"],
            "--structure_weight", str(p["structure_weight"]),
            "--gap_opening_cost", str(p["gap_opening_cost"]),
            "--gap_cost", str(p["gap_cost"]),
            "--max_shift", str(p["max_shift"]),
            "--shift_cost", str(p["shift_cost"]), "--lowmem"]
    proc = subprocess.run(
        [sys.executable, "-m", "bialign_tpu_torch.cli", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    want = (["Input:"]
            + [f"{k}\t {mol[k]}" for k in ("seqA", "seqB", "strA", "strB")]
            + [f"SCORE: {G.TOY_RNA_AFFINE_SCORE}", ""]
            + G.TOY_RNA_AFFINE_DEFAULT_OUT)
    check(proc.returncode == 0,
          f"CLI --lowmem exit {proc.returncode}: {proc.stderr[-2000:]}")
    check(proc.stdout.splitlines() == want,
          f"CLI --lowmem stdout {proc.stdout!r}")
    found["cli_toy_rna_affine_lowmem"] = "stdout equal"
    return found


def lowmem_big_pair(dev) -> dict:
    """The 4000x3990 pair, affine max_shift 1: the checkpointed fill and
    the blockwise traceback against the band kernel and its walk (score,
    trace, complete flag), with the times and peak memories of both."""
    n, m, S = BIG_PAIR
    t1, t2 = tables_to_torch(
        *rand_tables(np.random.default_rng(SEED), n, m), dev)
    fill = lambda: ckp.fill_affine_checkpoint(  # noqa: E731
        t1, t2, S, *AFFINE_PARAMS)
    fill()                                                    # warm-up
    _cb, low, report = lowmem_stages(fill, f"{n}x{m} affine max_shift {S}")
    del _cb

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fill_ms, band = cuda_ms(
        lambda: cuda_dp.fill_affine_device(t1, t2, S, *AFFINE_PARAMS), reps=1)
    score = band.final_score()
    walk_ms, full = cuda_ms(
        lambda: dtb.affine_traceback(band, *AFFINE_PARAMS, t1, t2), reps=1)
    report["band_path"] = dict(
        fill_ms=fill_ms, walk_ms=walk_ms, band_bytes=band.ys.numel() * 4,
        peak_bytes_above_tables=torch.cuda.max_memory_allocated() - base)
    del band
    check(low == full, f"{n}x{m}: the blockwise trace or its complete flag "
          "differs from the band path's")
    low_score = fill().final_score()
    check(low_score == score, f"{n}x{m}: lowmem score {low_score} != {score}")
    return dict(report, score=score, columns=len(low[0]), complete=low[1],
                equal_to_band_path=True)


def lowmem_huge_pair(dev) -> dict:
    """A 13000x12990 pair of random tables, affine max_shift 1, whose band
    would take 109 GB: the checkpointed score against affine_score, the
    trace complete, its columns summing to the pair's lengths, its score
    replayed column by column on the host."""
    n, m, S = HUGE_PAIR
    mu1, mu2 = rand_tables(np.random.default_rng(SEED + 1), n, m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1, t2 = tables_to_torch(mu1, mu2, dev)
    score_s, want = timed(
        lambda: cuda_dp.affine_score(t1, t2, S, *AFFINE_PARAMS))
    cb, (trace, complete), report = lowmem_stages(
        lambda: ckp.fill_affine_checkpoint(t1, t2, S, *AFFINE_PARAMS),
        f"{n}x{m} affine max_shift {S}")
    peak = torch.cuda.max_memory_allocated()
    score = cb.final_score()
    check(score == want, f"{n}x{m}: lowmem score {score} != affine_score "
          f"{want}")
    check(complete, f"{n}x{m}: incomplete traceback")
    replayed, end = replay_affine(trace, mu1, mu2, *AFFINE_PARAMS)
    check(end == (n, m, n, m), f"{n}x{m}: the trace's columns sum to {end}")
    check(replayed == score, f"{n}x{m}: replayed score {replayed} != {score}")
    band_bytes = (n + m + 1) * 9 * (2 * S + 1) ** 2 * (n + 1) * 4
    return dict(report, score=score, affine_score_s=score_s,
                columns=len(trace), complete=True, replayed_score=replayed,
                table_bytes=2 * t1.numel() * 4,
                max_memory_allocated=peak, full_band_bytes=band_bytes,
                device_memory_bytes=torch.cuda.get_device_properties(
                    dev).total_memory)


def phase_lowmem_main(mol, md5, G, dev) -> dict:
    """The low-memory path (counted launches)."""
    return dict(goldens=lowmem_goldens(G), dnapol=lowmem_dnapol(mol, md5),
                big_pair=lowmem_big_pair(dev),
                huge_pair=lowmem_huge_pair(dev))


def block_bound(cb, b: int, cases: int, states: int):
    """Bound of one block's fill: the checkpoint's two slabs and the block's
    table entries read once, the window's slabs (the block's diagonals and
    the two copied in) written once; the operations of the block's cells."""
    n, m, S = cb.n, cb.m, cb.max_shift
    d = np.arange(b * cb.block, min((b + 1) * cb.block, n + m + 1))
    cells = int((np.minimum(n, d) - np.maximum(0, d - m) + 1).sum())
    W2 = (2 * S + 1) ** 2
    slab = states * W2 * (n + 1) * 4
    return bound(2 * slab + 2 * cells * 4 + (len(d) + 2) * slab,
                 cells * W2 * states * cases * 2)


def phase_lowmem_timing(mol, errs: dict) -> tuple[dict, dict, dict]:
    """K9-K12 and the blockwise walks against their twins at the DNA-Pol-1
    shapes (not counted).  The checkpointed fill in turns with the
    score-only fill (what saving costs), and once from a ring and a
    checkpoint buffer of garbage beside the twin from the same garbage: all
    equal.  One block (the middle one) beside its twin, into the same
    garbage.  The traceback with events around every block's fill and walk
    (the kernels line), and again with a device sleep after every fill
    (the walks' own time, in the details); the host walk block by block over the kernel's windows, on the host
    clock, its tensor equal to the kernel's.  Returns (times, bounds,
    more)."""
    seqA, strA, seqB, strB = mol
    times, bounds, more = {}, {}, {}
    dev = torch.device("cuda")
    for affine, params in ((True, DNAPOL_FULL), (False, DNAPOL_CLI_DEFAULTS)):
        (fill, fill_plain, block, block_plain, walk_fn, walk_plain, _tb,
         _costs, (ckpt_name, block_name, walk_name)) = lowmem_forms(affine)
        ba = BiAligner(seqA, seqB, strA, strB, **params)
        t1, t2 = tables_to_torch(ba.mu1, ba.mu2, dev)
        S, n, m = ba.max_shift, len(seqA), len(seqB)
        p = (ba.beta, ba.gamma, ba.delta) if affine else (ba.gamma, ba.delta)
        cases, states = (15, 9) if affine else (13, 1)
        score = cuda_dp.affine_last_slab if affine \
            else cuda_dp.nonaffine_last_slab
        runs = {"score_only": lambda: score(t1, t2, S, *p),
                "checkpointed": lambda: fill(t1, t2, S, *p)}
        turns = {name: [] for name in runs}
        runs["checkpointed"]()                                # warm-up
        for name in ("score_only", "checkpointed", "checkpointed",
                     "score_only"):
            turns[name].append(cuda_ms(runs[name], reps=3)[0])

        cb = runs["checkpointed"]()
        junk = garbage_band(tuple(cb.ckpts.shape), dev)
        ring = garbage_band((3, *cb.final.shape), dev)
        got = fill(t1, t2, S, *p, ring=ring.clone(), ckpts=junk.clone())
        ms_p, twin = cuda_ms(lambda: fill_plain(t1, t2, S, *p, ring=ring,
                                                ckpts=junk), reps=1)
        e = max(tensor_err(got.ckpts, twin.ckpts),
                tensor_err(got.final, twin.final))
        check(e == 0, f"{ckpt_name} DNA-Pol checkpoints: max |err| {e}")
        errs[ckpt_name] = max(errs[ckpt_name], e)
        times[ckpt_name] = (min(turns["checkpointed"]), ms_p)
        b_ms, b_by = dp_bound(n, m, S, cases, states, band=False)
        saved = (cb.n_blocks - 1) * 2 * cb.final.numel() * 4
        bounds[ckpt_name] = bound(
            2 * (n + 1) * (m + 1) * 4 + cb.final.numel() * 4 + saved,
            (n + 1) * (m + 1) * (2 * S + 1) ** 2 * states * cases * 2)
        del got, twin, junk, ring

        mid = cb.n_blocks // 2
        junk = garbage_band(cb.window_shape, dev)
        ms_b, _w = cuda_ms(lambda: block(cb, mid), reps=5)
        window = block(cb, mid, window=junk.clone())
        ms_bp, want = cuda_ms(lambda: block_plain(cb, mid, window=junk),
                              reps=1)
        e = tensor_err(window, want)
        check(e == 0, f"{block_name} DNA-Pol block {mid}: max |err| {e}")
        errs[block_name] = max(errs[block_name], e)
        times[block_name] = (ms_b, ms_bp)
        bounds[block_name] = block_bound(cb, mid, cases, states)
        del junk, want

        timed_traceback(cb)                                   # warm-up
        result, blocks_ms, walks_ms, seconds, _ahead = timed_traceback(cb)
        walk_k, walk_p = ckp.new_walk(cb), ckp.new_walk(cb, "cpu")
        host_ms = 0.0
        for b in range(cb.n_blocks - 1, -1, -1):
            window = block(cb, b, window=window)
            walk_fn(cb, b, window, walk_k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            walk_plain(cb, b, window, walk_p)
            host_ms += (time.perf_counter() - t0) * 1e3
        e = tensor_err(walk_k.cpu(), walk_p)
        check(e == 0, f"{walk_name} DNA-Pol: max |err| {e} in the walk's "
              "state and codes")
        errs[walk_name] = max(errs[walk_name], e)
        steps = int(walk_p[ckp.STATE])
        _r, _b, queued_ms, _s, ahead = timed_traceback(cb, HEAD_START_CYCLES)
        times[walk_name] = (walks_ms, host_ms)
        bounds[walk_name] = walk_bound(steps, cases)
        launches = n + m + 1
        more[ckpt_name] = dict(
            block=cb.block, blocks=cb.n_blocks, turns_ms=turns,
            us_per_launch=min(turns["checkpointed"]) * 1e3 / launches,
            score_only_us_per_launch=min(turns["score_only"]) * 1e3
            / launches,
            saving_costs_share=min(turns["checkpointed"])
            / min(turns["score_only"]) - 1,
            checkpoint_bytes=cb.ckpts.numel() * 4,
            score_only_bound_ms=b_ms, score_only_bound_by=b_by)
        more[block_name] = dict(
            one_block=mid, diagonals=cb.window_shape[0] - 2,
            window_bytes=int(np.prod(cb.window_shape)) * 4,
            all_block_fills_ms=blocks_ms,
            us_per_launch=blocks_ms * 1e3 / launches)
        more[walk_name] = dict(columns=steps, launches=cb.n_blocks,
                               all_block_walks_ms=walks_ms,
                               walks_ms_after_a_head_start=queued_ms,
                               host_ahead=ahead, traceback_s=seconds)
    return times, bounds, more


# fill kernel of the kernels line -> (batch of phase_batch_main, its walk,
# cases, states)
ALIGN_TIMED = {
    "batch_fill_affine": ("realistic", "walk_affine_batch", 15, 9),
    "batch_fill_nonaffine": ("dnapol_nonaffine_x4", "walk_nonaffine_batch",
                             13, 1)}


def phase_align_timing(batches, errs: dict) -> tuple[dict, dict, dict]:
    """K4 and K5 in band mode and the batch walks against their plain twins
    on the batches of the main path (not counted), bucket by bucket with
    the tables resident: CUDA events around three fills into fresh memory
    and three walks; the twin fill once on the card from a band of garbage,
    which the kernel must leave equal in every cell; the host walk over
    every pair's own band, on the host clock.  Beside them the time to set a
    bucket's band to INVALID, which the fill does without.  Returns (times,
    bounds, more)."""
    times, bounds, more = {}, {}, {}
    dev = torch.device("cuda")
    for fill_name, (batch, walk_name, cases, states) in ALIGN_TIMED.items():
        tables, lengths, S, params, affine, quantum = batches[batch]
        _form, fill, fill_plain, _scores, walk, walk_plain, *_rest = \
            align_forms(S)[0 if affine else 1]
        ms = dict(fill=0.0, walk=0.0, fill_plain=0.0, walk_plain=0.0,
                  set_invalid=0.0)
        per_bucket, steps, launches, band_bytes = [], 0, 0, 0
        for _idx, st, d_max in pbatch._device_buckets(tables, quantum, dev):
            run = lambda band=None: fill(  # noqa: E731
                *st, S, *params, d_max=d_max, band=band)
            run()                                             # warm-up
            ms_f, (bband, _sc) = cuda_ms(run, reps=3)
            walk(bband, *params, *st[:2])
            ms_w, _out = cuda_ms(lambda: walk(bband, *params, *st[:2]),
                                 reps=3)
            ms_i, _ys = cuda_ms(
                lambda: bband.ys.fill_(cuda_dp.INVALID), reps=1)
            shape = tuple(bband.ys.shape)
            del bband, _ys

            junk = garbage_band(shape, dev)
            bk, sk = run(junk.clone())
            ms_fp, (bp, sp) = cuda_ms(
                lambda: fill_plain(*st, S, *params, d_max=d_max, band=junk),
                reps=1)
            e = max(batch_band_err(bk, bp), score_err(sk, sp))
            check(e == 0, f"{fill_name} on {batch} {shape}: max |err| {e}")
            errs[fill_name] = max(errs[fill_name], e)
            t0 = time.perf_counter()
            wp = walk_plain(bp, *params, *st[:2])
            ms_wp = (time.perf_counter() - t0) * 1e3
            e, n_steps = walks_err(walk(bk, *params, *st[:2]), wp)
            check(e == 0, f"{walk_name} on {batch} {shape}: max |err| {e}")
            errs[walk_name] = max(errs[walk_name], e)
            del junk, bk, bp

            for key, val in zip(ms, (ms_f, ms_w, ms_fp, ms_wp, ms_i)):
                ms[key] += val
            steps += n_steps
            launches += d_max + 1
            band_bytes += int(np.prod(shape)) * 4
            per_bucket.append(dict(band_shape=shape, fill_ms=ms_f,
                                   walk_ms=ms_w, set_invalid_ms=ms_i,
                                   columns=n_steps))
        times[fill_name] = (ms["fill"], ms["fill_plain"])
        times[walk_name] = (ms["walk"], ms["walk_plain"])
        bounds[fill_name] = band_bound(lengths, S, cases, states)
        bounds[walk_name] = walk_bound(steps, cases)
        more[fill_name] = dict(
            batch=batch, buckets=per_bucket, kernel_launches_per_run=launches,
            us_per_launch=ms["fill"] * 1e3 / launches, band_bytes=band_bytes,
            set_invalid_ms=ms["set_invalid"])
        more[walk_name] = dict(batch=batch, columns=steps,
                               kernel_launches_per_run=len(per_bucket))
    return times, bounds, more


def batch_of_one(t1, t2):
    """The stacks of a bucket that holds the one pair of tables t1, t2."""
    n, m = t1.shape[0] - 1, t1.shape[1] - 1
    lengths = [torch.tensor([x], dtype=torch.int32, device=t1.device)
               for x in (n, m)]
    return (t1[None].contiguous(), t2[None].contiguous(), *lengths)


def tile_against_bucket(score_slab, batch_scores, t1, t2, S, p) -> dict:
    """The single-pair tile kernel's score-only fill (K1 or K2) in turns
    with the bucket kernel (K4 or K5, route "grid") on the same pair as a
    batch of one: the same tile under the bucket's launch, on the same pair
    and the same card.  Both give the score; ms by CUDA events, 3 runs a
    turn."""
    n, m = t1.shape[0] - 1, t1.shape[1] - 1
    stacks = batch_of_one(t1, t2)
    runs = {"tile": lambda: score_slab(t1, t2, S, *p),
            "bucket": lambda: batch_scores(*stacks, S, *p, route="grid")}
    turns = {name: [] for name in runs}
    for name in runs:
        runs[name]()                                          # warm-up
    for name in ("tile", "bucket", "bucket", "tile"):
        turns[name].append(cuda_ms(runs[name], reps=3)[0])
    slab = runs["tile"]()
    want = int(slab[..., S, S, n].max())
    check(int(runs["bucket"]()[0]) == want, "batch of one != score-only fill")
    launches = n + m + 1
    return dict(turns_ms=turns, launches=launches,
                tile_us_per_launch=min(turns["tile"]) * 1e3 / launches,
                bucket_us_per_launch=min(turns["bucket"]) * 1e3 / launches,
                bucket_over_tile=min(turns["bucket"]) / min(turns["tile"]))


def phase_full_timing(mol, errs: dict) -> tuple[dict, dict, dict]:
    """Kernels against plain twins at the DNA-Pol-1 shapes (not counted);
    returns (times, bounds, more) by kernel name: ``more`` has the tile
    kernels' microseconds a launch and their time beside the bucket kernel
    on the same pair as a batch of one."""
    seqA, strA, seqB, strB = mol
    times, bounds, more = {}, {}, {}
    for name, params in (("affine", DNAPOL_FULL),
                         ("nonaffine", DNAPOL_CLI_DEFAULTS)):
        ba = BiAligner(seqA, seqB, strA, strB, engine="torch",
                       device="cuda", **params)
        t1, t2 = tables_to_torch(ba.mu1, ba.mu2, "cuda")
        S = ba.max_shift
        if name == "affine":
            p = (ba.beta, ba.gamma, ba.delta)
            kern, plain = cuda_dp.fill_affine_device, cuda_dp.fill_affine_plain
        else:
            p = (ba.gamma, ba.delta)
            kern = cuda_dp.fill_nonaffine_device
            plain = cuda_dp.fill_nonaffine_plain
        kern(t1, t2, S, *p)                                   # warm-up
        ms_k, bk = cuda_ms(lambda: kern(t1, t2, S, *p), reps=5)
        ms_p, bp = cuda_ms(lambda: plain(t1, t2, S, *p), reps=1)
        e = band_err(bk, bp)
        check(e == 0, f"fill_{name} DNA-Pol band: max |err| {e}")
        errs[f"fill_{name}"] = max(errs[f"fill_{name}"], e)
        times[f"fill_{name}"] = (ms_k, ms_p)
        n, m = bk.n, bk.m
        more[f"fill_{name}"] = dict(us_per_launch=ms_k * 1e3 / (n + m + 1))
        cases, states = (15, 9) if name == "affine" else (13, 1)
        bounds[f"fill_{name}"] = dp_bound(n, m, S, cases, states, band=True)

        # the same recurrence, score only
        if name == "affine":
            kern, plain = cuda_dp.affine_last_slab, cuda_dp.affine_last_slab_plain
        else:
            kern = cuda_dp.nonaffine_last_slab
            plain = cuda_dp.nonaffine_last_slab_plain
        kern(t1, t2, S, *p)                                   # warm-up
        ms_k, sk = cuda_ms(lambda: kern(t1, t2, S, *p), reps=5)
        ms_p, sp = cuda_ms(lambda: plain(t1, t2, S, *p), reps=1)
        e = max(row_err(sk, sp, n), row_err(sk, bk.ys[n + m], n))
        check(e == 0, f"score_{name} DNA-Pol last slab: max |err| {e}")
        errs[f"score_{name}"] = max(errs[f"score_{name}"], e)
        times[f"score_{name}"] = (ms_k, ms_p)
        bounds[f"score_{name}"] = dp_bound(n, m, S, cases, states, band=False)
        more[f"score_{name}"] = dict(
            us_per_launch=ms_k * 1e3 / (n + m + 1),
            beside_the_bucket_kernel=tile_against_bucket(
                kern, cuda_dp.affine_batch_scores if name == "affine"
                else cuda_dp.nonaffine_batch_scores, t1, t2, S, p))

        if name == "affine":             # K3 on its routes, in turns
            k3 = {route: lambda route=route: cuda_dp.affine_ms0_last_slab(
                t1, t2, *p, route=route)
                for route in ("cta", "resident", "grid")}
            turns = {route: [] for route in k3}
            for route in k3:
                k3[route]()                                   # warm-up
            for route in [*k3, *reversed(k3)]:
                turns[route].append(cuda_ms(k3[route], reps=5)[0])
            ms_p, sp = cuda_ms(
                lambda: cuda_dp.affine_ms0_last_slab_plain(t1, t2, *p), reps=1)
            for route, key in (("cta", "score_affine_ms0"),
                               ("resident", "score_affine_ms0_resident"),
                               ("grid", "score_affine_ms0_grid")):
                e = row_err(k3[route](), sp, n)
                check(e == 0, f"{key} DNA-Pol last slab: |err| {e}")
                errs[key] = max(errs[key], e)
                if route != "resident":   # its line: at MS0_BEYOND
                    times[key] = (min(turns[route]), ms_p)
                    # three live states, three sources each, no shift axes
                    bounds[key] = dp_bound(n, m, 0, 3, 3, band=False)
                more[key] = dict(
                    turns_ms=turns[route],
                    launches=n + m + 1 if route == "grid" else 1,
                    us_per_diagonal=min(turns[route]) * 1e3 / (n + m + 1))

        if name == "affine":
            walk = lambda: dtb.affine_traceback(bk, *p, t1, t2)[0]  # noqa
            t0 = time.perf_counter()
            tp = dtb.affine_traceback_plain(bp, *p, t1, t2)[0]
        else:
            walk = lambda: dtb.nonaffine_traceback(bk, *p, t1, t2)  # noqa
            t0 = time.perf_counter()
            tp = dtb.nonaffine_traceback_plain(bp, *p, t1, t2)
        ms_wp = (time.perf_counter() - t0) * 1e3
        walk()                                                # warm-up
        ms_w, tk = cuda_ms(walk, reps=5)
        e = trace_err(tk, tp)
        check(e == 0, f"walk_{name} DNA-Pol trace differs")
        errs[f"walk_{name}"] = max(errs[f"walk_{name}"], e)
        times[f"walk_{name}"] = (ms_w, ms_wp)
        bounds[f"walk_{name}"] = walk_bound(len(tk), cases)
    return times, bounds, more


def tile_times(mol) -> dict:
    """Milliseconds (CUDA events, 5 runs after a warm-up) of the tile
    kernels alone, no twins: K1, K2 band and score-only, K4/K5 as a batch
    of one, K9/K11 and one block of K10/K12 at the DNA-Pol-1 shapes; K4
    score and band mode and K8 on the realistic batch.  Every checkout of
    the port since its tile kernels makes these calls the same way
    (--tile-times)."""
    seqA, strA, seqB, strB = mol
    dev = torch.device("cuda")
    found = {}
    for affine, params in ((True, DNAPOL_FULL), (False, DNAPOL_CLI_DEFAULTS)):
        kind = "affine" if affine else "nonaffine"
        ba = BiAligner(seqA, seqB, strA, strB, engine="torch", device="cuda",
                       **params)
        t1, t2 = tables_to_torch(ba.mu1, ba.mu2, dev)
        S = ba.max_shift
        p = (ba.beta, ba.gamma, ba.delta) if affine else (ba.gamma, ba.delta)
        fill, _fp, block, *_rest = lowmem_forms(affine)
        cb = fill(t1, t2, S, *p)
        stacks = batch_of_one(t1, t2)
        runs = {
            f"fill_{kind}": (cuda_dp.fill_affine_device if affine
                             else cuda_dp.fill_nonaffine_device),
            f"score_{kind}": (cuda_dp.affine_last_slab if affine
                              else cuda_dp.nonaffine_last_slab),
            f"ckpt_{kind}": fill}
        runs = {name: lambda fn=fn: fn(t1, t2, S, *p)
                for name, fn in runs.items()}
        runs[f"block_{kind}"] = lambda: block(cb, cb.n_blocks // 2)
        runs[f"batch_{kind}_one_pair"] = lambda: (
            cuda_dp.affine_batch_scores if affine
            else cuda_dp.nonaffine_batch_scores)(*stacks, S, *p, route="grid")
        for name, run in runs.items():
            run()                                             # warm-up
            found[name] = cuda_ms(run, reps=5)[0]
        del cb

    pairs = [host_tables(w, DNAPOL_FULL) for w in realistic_windows(mol, SEED)]
    costs = (DNAPOL_FULL["gap_opening_cost"], DNAPOL_FULL["gap_cost"],
             DNAPOL_FULL["shift_cost"])
    batch = ([q[:2] for q in pairs], [q[2] for q in pairs], 1, costs, True,
             REALISTIC_QUANTUM)
    runs = {"batch_affine_realistic": routed(batch, "grid")[0],
            "conveyor_scores_realistic": routed(batch, "conveyor")[0]}
    buckets = pbatch._device_buckets(batch[0], REALISTIC_QUANTUM, dev)
    runs["batch_fill_affine_realistic"] = lambda: [
        cuda_dp.affine_batch_bands(*st, 1, *costs, d_max=d_max)[1]
        for _idx, st, d_max in buckets]
    for name, run in runs.items():
        run()                                                 # warm-up
        found[name] = cuda_ms(run, reps=3)[0]
    return found


def chain_latency(dev) -> dict:
    """ns a dependent load from device memory and from the L2: the
    pointer-chase probe (csrc/probe.cu) over a random cycle through the
    128-byte lines of a buffer of PROBE_BYTES, PROBE_HOPS loads.  The
    device-memory run is timed once after a one-load warm-up, so its lines
    are cold; the L2 run three times after a full warm-up pass."""
    found = {}
    for where, nbytes in PROBE_BYTES.items():
        lines = nbytes // 128
        order = torch.randperm(lines, device=dev)
        nxt = torch.zeros(lines * 32, dtype=torch.int32, device=dev)
        nxt[order * 32] = (torch.roll(order, -1) * 32).to(torch.int32)
        sink = torch.zeros(1, dtype=torch.int32, device=dev)
        del order
        if where == "hbm":          # writes that push the chain out of L2
            torch.empty(256 << 20, dtype=torch.uint8, device=dev).fill_(1)
        warm, reps = (1, 1) if where == "hbm" else (PROBE_HOPS, 3)
        _build.launch("bialign_probe_chase", dev, nxt, warm, sink)
        ms, _ = cuda_ms(lambda: _build.launch(
            "bialign_probe_chase", dev, nxt, PROBE_HOPS, sink), reps=reps)
        found[f"ns_per_load_{where}"] = ms * 1e6 / PROBE_HOPS
        found[f"buffer_bytes_{where}"] = nbytes
        del nxt
    return found


def walk_times(mol) -> dict:
    """The walk kernels alone, no twins, through the C functions of
    csrc/walk.cu, whose signatures every checkout since the walks shares:
    ms by CUDA events (5 runs after a warm-up; the block walks as the
    traceback queues them, after a warm-up traceback), steps, and
    microseconds a step of the longest chain a launch.  The single-pair
    walks at the DNA-Pol-1 shapes (affine max_shift 1, the non-affine CLI
    defaults) and of the 4000x3990 pair, the realistic batch's batch walks
    (one launch a bucket), the DNA-Pol-1 low-memory traceback's block walks
    with a device sleep after every block's fill, so that the host is
    ahead at every walk (and inside the traceback as phase 5 times them).
    Where the checkout has csrc/probe.cu, also the probe's latencies and
    each walk's chain floor: its longest chains' steps x the ns a
    dependent load."""
    seqA, strA, seqB, strB = mol
    dev = torch.device("cuda", torch.cuda.current_device())
    found = {}

    def single(key, band, t1, t2, kind, p):
        n, m = band.n, band.m
        lmax = 2 * (n + m) + 1
        out = torch.empty(3 + lmax, dtype=torch.int32, device=dev)
        cases = cuda_dp._device_cases(kind, tuple(p), dev)
        run = lambda: _build.launch(  # noqa: E731
            f"bialign_walk_{kind}", dev, band.ys, t1, t2, cases, n, m,
            band.max_shift, out, lmax)
        run()                                                 # warm-up
        ms = cuda_ms(run, reps=5)[0]
        steps = int(out[0])
        found[key] = dict(ms=ms, steps=steps, longest_chains=steps,
                          launches=1, us_per_step=ms * 1e3 / max(steps, 1))

    for affine, params in ((True, DNAPOL_FULL), (False, DNAPOL_CLI_DEFAULTS)):
        kind = "affine" if affine else "nonaffine"
        ba = BiAligner(seqA, seqB, strA, strB, engine="torch", device="cuda",
                       **params)
        t1, t2 = tables_to_torch(ba.mu1, ba.mu2, dev)
        S = ba.max_shift
        p = (ba.beta, ba.gamma, ba.delta) if affine else (ba.gamma, ba.delta)
        fill = (cuda_dp.fill_affine_device if affine
                else cuda_dp.fill_nonaffine_device)
        band = fill(t1, t2, S, *p)
        single(f"walk_{kind}_dnapol", band, t1, t2, kind, p)
        del band
        lowmem_fill = lowmem_forms(affine)[0]
        cb = lowmem_fill(t1, t2, S, *p)
        timed_traceback(cb)                                   # warm-up
        inside_ms = timed_traceback(cb)[2]
        result, _b, walks_ms, _s, ahead = timed_traceback(
            cb, HEAD_START_CYCLES)
        steps = len(result[0] if cb.affine else result)
        found[f"walk_{kind}_block_dnapol"] = dict(
            ms=walks_ms, steps=steps, longest_chains=steps,
            launches=cb.n_blocks, block=cb.block, host_ahead=ahead,
            ms_inside_the_traceback=inside_ms,
            us_per_step=walks_ms * 1e3 / max(steps, 1))
        del cb

    n, m, S = BIG_PAIR
    t1, t2 = tables_to_torch(
        *rand_tables(np.random.default_rng(SEED), n, m), dev)
    band = cuda_dp.fill_affine_device(t1, t2, S, *AFFINE_PARAMS)
    single("walk_affine_4000x3990", band, t1, t2, "affine", AFFINE_PARAMS)
    del band, t1, t2

    pairs = [host_tables(w, DNAPOL_FULL) for w in realistic_windows(mol, SEED)]
    costs = (DNAPOL_FULL["gap_opening_cost"], DNAPOL_FULL["gap_cost"],
             DNAPOL_FULL["shift_cost"])
    total = dict(ms=0.0, steps=0, longest_chains=0, launches=0)
    for _idx, st, d_max in pbatch._device_buckets(
            [q[:2] for q in pairs], REALISTIC_QUANTUM, dev):
        bband, _sc = cuda_dp.affine_batch_bands(*st, 1, *costs, d_max=d_max)
        run = lambda: dtb.affine_walk_batch(  # noqa: E731
            bband, *costs, *st[:2])
        run()                                                 # warm-up
        ms, out = cuda_ms(run, reps=5)
        chains = out[:, 0].cpu()
        total["ms"] += ms
        total["steps"] += int(chains.sum())
        total["longest_chains"] += int(chains.max())
        total["launches"] += 1
        del bband
    total["us_per_step"] = total["ms"] * 1e3 / total["longest_chains"]
    found["walk_affine_batch_realistic"] = total

    if (_build.CSRC / "probe.cu").exists():
        chain = chain_latency(dev)
        found["chain"] = chain
        for key, row in found.items():
            if key != "chain":
                for where in PROBE_BYTES:
                    floor = (row["longest_chains"]
                             * chain[f"ns_per_load_{where}"] * 1e-6)
                    row[f"floor_ms_{where}"] = floor
                    row[f"share_of_floor_{where}"] = floor / row["ms"]
    return found


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")   # device activity
PROFILED = (("affine_ms1", DNAPOL_FULL),
            ("nonaffine_ms2_cli_defaults", DNAPOL_CLI_DEFAULTS))
# the score-only runs: (name, parameters, golden score if there is one)
SCORED = (("affine_ms1", DNAPOL_FULL, 761500),
          ("affine_ms0", dict(DNAPOL_FULL, max_shift=0), None),      # K3
          ("affine_ms2", dict(DNAPOL_FULL, max_shift=2), None),
          ("nonaffine_ms2_cli_defaults", DNAPOL_CLI_DEFAULTS, None))


def staged_run(mol, params) -> dict:
    """One end-to-end run timed stage by stage on the host clock, each
    stage closed by a device sync: molecules and tables (host), fill (with
    the tables' copy to the card), score, walk (with its one copy back),
    decode (host)."""
    seqA, strA, seqB, strB = mol
    clock = time.perf_counter
    torch.cuda.synchronize()
    t = [clock()]
    ba = BiAligner(seqA, seqB, strA, strB, **params)
    t.append(clock())
    ba._fill()
    torch.cuda.synchronize()
    t.append(clock())
    score = ba._band.final_score()
    t.append(clock())
    trace = ba.traceback()
    t.append(clock())
    list(ba.decode_trace(trace))
    t.append(clock())
    stages = ("tables_s", "fill_s", "score_s", "walk_s", "decode_s")
    return dict(zip(stages, np.diff(t).tolist()), score=score)


def kernel_name(name: str) -> str:
    """A traced device event's name without its argument list."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:80].strip()


# The profiler of a --profile-one process, prepared before the process's
# turn (the first session of a process sets up CUPTI: 10-14 s on an H100's
# host, PERF.md §6); the process's one trace is taken with it.
PREPARED = []


def prepared_profiler():
    """A profiler of the host and the card with its session set up, the
    card drained first; nothing is recorded until its start_trace(), and
    nothing may run on the card before that (profile_setup)."""
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.prepare_trace()
    return prof


def traced(run, trace_path: Path) -> tuple:
    """One ``run()`` under torch.profiler (the prepared one of PREPARED, if
    any).  From the exported trace: (summary, device events): the device's
    busy time (the union of its kernel, memcpy and memset intervals) and
    idle share inside the run's window and each kernel's count and time;
    the events as sorted (start, end, name) in microseconds."""
    prof = PREPARED.pop() if PREPARED else prepared_profiler()
    prof.start_trace()
    try:
        with record_function("e2e"):
            run()
        torch.cuda.synchronize()
    finally:
        prof.stop_trace()
    prof.export_chrome_trace(str(trace_path))
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (win,) = [e for e in events
              if e["name"] == "e2e" and e.get("cat") == "user_annotation"]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = sorted((e["ts"], e["ts"] + e["dur"], kernel_name(e["name"]))
                 for e in events if e.get("cat") in DEVICE_CATS)
    busy, covered = 0.0, w0
    for s, f, _name in dev:
        s, f = max(s, covered), min(f, w1)
        if f > s:
            busy += f - s
            covered = f
    kernels = {}
    for s, f, name in dev:
        k = kernels.setdefault(name, {"count": 0, "total_us": 0.0})
        k["count"] += 1
        k["total_us"] += f - s
    summary = dict(window_us=w1 - w0, device_busy_us=busy,
                   device_idle_share=1 - busy / (w1 - w0), kernels=kernels)
    return summary, dev


def missing_kernels_report(before: dict, trace_path: Path) -> str:
    """What to print when a trace holds fewer DP kernels than the run
    launched: the launch counters' counts in the run (wrapper calls, each a
    loop of launches) and every entry of the exported trace that speaks of
    dropped or overflowed records."""
    launched = {k: v - before.get(k, 0) for k, v in counts().items()
                if v != before.get(k, 0)}
    data = json.loads(Path(trace_path).read_text())
    entries = [(k, v) for k, v in data.items() if k != "traceEvents"]
    entries += [(e.get("name"), e) for e in data.get("traceEvents", [])
                if e.get("ph") in ("M", "i", "I")]
    dropped = []
    for name, value in entries:
        text = json.dumps(value).lower()
        if "drop" in text or "overflow" in text:
            dropped.append((name, text[:400]))
    return (f"the run's launch counts {launched}; the profiler's records of "
            f"dropped events {dropped or 'none'}")


def dp_kernel_stats(dev, marks) -> tuple:
    """(durations, gaps between consecutive ones) in microseconds of the
    traced kernels whose name holds one of ``marks``, in order."""
    spans = [(s, f) for s, f, name in dev if any(k in name for k in marks)]
    dur = np.array([f - s for s, f in spans])
    gaps = np.array([b[0] - a[1] for a, b in zip(spans, spans[1:])])
    return spans, dur, gaps


def profiled_run(run, n: int, m: int, trace_path: Path) -> dict:
    """One end-to-end ``run()`` of an n x m pair under torch.profiler: the
    summary of :func:`traced`, and for the DP kernels (one per diagonal d,
    in order) the gaps between them and their mean time by live rows on the
    diagonal."""
    before = counts()
    summary, dev = traced(run, trace_path)
    fills, dur, gaps = dp_kernel_stats(dev, ("_diag",))
    check(len(fills) == n + m + 1, f"{len(fills)} DP kernels traced of "
          f"{n + m + 1}; {missing_kernels_report(before, trace_path)}")
    d = np.arange(n + m + 1)
    rows = np.minimum(n, d) - np.maximum(0, d - m) + 1
    return dict(
        summary,
        fill=dict(kernels=len(fills), mean_us=dur.mean(),
                  mean_gap_us=gaps.mean(),
                  busy_share_of_fill_span=dur.sum()
                  / (fills[-1][1] - fills[0][0]),
                  mean_us_rows_le_128=dur[rows <= 128].mean(),
                  mean_us_rows_ge_800=dur[rows >= 800].mean()),
    )


def profiled_one_kernel(run, trace_path: Path) -> dict:
    """One ``run()`` whose DP is one launch of the one-CTA kernel (score-only
    K3) under torch.profiler: the summary of :func:`traced` and that
    kernel's time."""
    summary, dev = traced(run, trace_path)
    spans, dur, _gaps = dp_kernel_stats(dev, ("cta_ms0",))
    check(len(spans) == 1, f"{len(spans)} one-CTA kernels traced")
    check(not dp_kernel_stats(dev, ("_diag",))[0],
          "a per-diagonal kernel ran beside the one-CTA kernel")
    return dict(summary, fill=dict(kernels=1, us=float(dur[0]),
                                   share_of_window=float(dur[0])
                                   / summary["window_us"]))


def profiled_lowmem(run, n: int, m: int, trace_path: Path) -> dict:
    """One end-to-end lowmem ``run()`` of an n x m pair under
    torch.profiler: the summary of :func:`traced`; the DP kernels (the
    checkpointed fill's, then the block fills': twice n+m+1), the block
    walks, the slab copies, the copies back to the host, and the longest
    time the device stood still between the first and the last DP kernel
    (a host round trip between blocks would show there)."""
    before = counts()
    summary, dev = traced(run, trace_path)
    fills, dur, gaps = dp_kernel_stats(dev, ("_diag",))
    check(len(fills) == 2 * (n + m + 1), f"{len(fills)} DP kernels traced "
          f"of {2 * (n + m + 1)}; "
          f"{missing_kernels_report(before, trace_path)}")
    walks, walk_dur, _g = dp_kernel_stats(dev, ("walk_",))
    half = n + m + 1
    inside = [(s, f) for s, f, _name in dev         # the traceback's events
              if fills[half][0] <= s and f <= fills[-1][1]]
    still = max((b[0] - a[1] for a, b in zip(inside, inside[1:])),
                default=0.0)
    copies = {name: k for name, k in summary["kernels"].items()
              if "Memcpy" in name or "Memset" in name}
    return dict(
        summary,
        ckpt_fill=dict(kernels=half, mean_us=dur[:half].mean(),
                       mean_gap_us=gaps[:half - 1].mean()),
        block_fills=dict(kernels=half, mean_us=dur[half:].mean(),
                         mean_gap_us=gaps[half:].mean()),
        block_walks=dict(kernels=len(walks), total_us=walk_dur.sum()),
        copies=copies, longest_device_standstill_us=still)


def staged_batch(tables, S, params, affine, quantum) -> dict:
    """One batch timed stage by stage on the host clock: buckets, stacks
    and their copy to the card (closed by a device sync), the queueing of
    every bucket's kernels (not waited for), the wait for them, and the
    scores' one copy back."""
    clock = time.perf_counter
    torch.cuda.synchronize()
    t = [clock()]
    prep = pbatch.PreparedBatch(tables, S, params, affine=affine,
                                bucket_quantum=quantum)
    torch.cuda.synchronize()
    t.append(clock())
    pending = prep.dispatch()
    t.append(clock())
    torch.cuda.synchronize()
    t.append(clock())
    pending.get()
    t.append(clock())
    stages = ("pack_and_upload_s", "queue_kernels_s", "wait_kernels_s",
              "fetch_scores_s")
    return dict(zip(stages, np.diff(t).tolist()))


def profiled_batch(run, trace_path: Path) -> dict:
    """One batch ``run()`` under torch.profiler: the summary of
    :func:`traced` and the bucket kernels' count, mean time and gaps."""
    summary, dev = traced(run, trace_path)
    spans, dur, gaps = dp_kernel_stats(dev, ("batch_tile", "cta_scores",
                                            "conveyor_tile"))
    check(len(spans) > 0, "no bucket kernel traced")
    return dict(
        summary,
        bucket_kernels=dict(
            kernels=len(spans), mean_us=dur.mean(), max_us=dur.max(),
            total_us=dur.sum(),
            mean_gap_us=gaps.mean() if len(gaps) else 0.0,
            busy_share_of_their_span=dur.sum()
            / (spans[-1][1] - spans[0][0])),
    )


def staged_align(dispatch) -> dict:
    """One batch of alignments timed stage by stage on the host clock:
    ``dispatch()`` (buckets, stacks, upload and the queueing of every
    chunk's fill and walk: the host returns), the wait for the device, the
    walks' one copy back, and the host's decoding of the codes."""
    clock = time.perf_counter
    torch.cuda.synchronize()
    t = [clock()]
    pending = dispatch()
    t.append(clock())
    torch.cuda.synchronize()
    t.append(clock())
    torch.cat([dev.reshape(-1) for _i, _a, dev in pending._parts]).cpu()
    t.append(clock())
    pending.get()                           # the same copy again, and decode
    t.append(clock())
    d = np.diff(t).tolist()
    return dict(pack_upload_and_queue_s=d[0], wait_s=d[1], copy_back_s=d[2],
                decode_s=d[3] - d[2])


def profiled_align(run, trace_path: Path) -> dict:
    """One batch of alignments under torch.profiler: the summary of
    :func:`traced`, the band-mode fill kernels and the batch walks."""
    summary, dev = traced(run, trace_path)
    spans, dur, gaps = dp_kernel_stats(dev, ("batch_tile",))
    _w, walks, _g = dp_kernel_stats(dev, ("walk_",))
    check(len(spans) > 0 and len(walks) > 0, "no fill or no walk traced")
    copies = {name: k for name, k in summary["kernels"].items()
              if "Memcpy" in name or "Memset" in name}
    return dict(
        {k: v for k, v in summary.items() if k != "kernels"},
        fill_kernels=dict(kernels=len(spans), mean_us=dur.mean(),
                          total_us=dur.sum(), mean_gap_us=gaps.mean()),
        walk_kernels=dict(kernels=len(walks), total_us=walks.sum(),
                          us_each=walks.tolist()),
        copies=copies, kernels=summary["kernels"])


def staged_score(mol, params) -> dict:
    """One score-only run timed on the host clock: molecules and tables
    (host), then the tables' copy, the kernel's launches and the score's
    copy back, closed by a device sync."""
    clock = time.perf_counter
    torch.cuda.synchronize()
    t0 = clock()
    ba, t1, t2 = port_tables(mol, params)
    torch.cuda.synchronize()
    t1_ = clock()
    score = score_only(ba, t1, t2)
    torch.cuda.synchronize()
    return dict(tables_s=t1_ - t0, score_s=clock() - t1_, score=score)


PROFILE_BATCHES = {"realistic": realistic_batch,
                   "toy_b512": lambda _mol: toy_batch()}
PROFILE_ALIGNS = ("realistic_tables", "realistic_codes")
# the stress phase: DNA-Pol-1 band-path traces, each in a process of its
# own, after a large trace in this one; with --profile-stress, the seconds
# a prepared profiler's session idles before its trace ("gap_idle")
STRESS_TRACES = 20
GAP_IDLE_S = 30


def profile_names() -> list:
    """Phase 7's measurements, in order, each with at most one trace."""
    return ([name for name, _params in PROFILED] + ["lowmem_affine_ms1"]
            + [f"score_only_{name}" for name, _p, _w in SCORED]
            + [f"batch_{b}{form}" for b in PROFILE_BATCHES
               for form in ("", "_prepared")]
            + [f"align_{name}" for name in PROFILE_ALIGNS]
            + ["split_k4", "split_k4_resident", "stream_alignments_codes"])


def profile_setup(name: str, out: Path):
    """What one measurement of phase 7 (or of the stress phase: "band_trace",
    and with --profile-stress "gap_idle" and "gap_busy") does before its
    trace, in a process of its own (--profile-one): tables, batches and a
    warm-up run.  Returns measure(), which takes the one trace (to ``out``)
    and then the staged runs, and returns the result.  Nothing runs on the
    card between the profiler's preparation and the trace: a session
    prepared before a run on the card lost records of its trace or held
    records of that run (PERF.md §6)."""
    mol = dnapol_pair()
    n, m = len(mol[0]), len(mol[2])
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"trace_{name}.json"
    runs = dict(PROFILED, lowmem_affine_ms1=dict(DNAPOL_FULL, lowmem=True))
    scored = {f"score_only_{k}": params for k, params, _want in SCORED}
    band = lambda: run_e2e(mol, DNAPOL_FULL)  # noqa: E731
    if name in ("band_trace", "gap_idle", "gap_busy"):
        band()

        def measure():
            if name == "gap_idle":          # the prepared session idles
                time.sleep(GAP_IDLE_S)
            elif name == "gap_busy":        # ... or sees a run first
                band()
            if name == "band_trace":
                return profiled_run(band, n, m, trace)["fill"]
            summary, dev = traced(band, trace)
            return dict(dp_kernels=len(dp_kernel_stats(dev, ("_diag",))[0]),
                        walk_traced=any("walk_" in k
                                        for k in summary["kernels"]))
        return measure
    if name in runs:
        params = runs[name]
        run_e2e(mol, params)
        profiled = profiled_lowmem if params.get("lowmem") else profiled_run

        def measure():
            profile = profiled(lambda: run_e2e(mol, params), n, m, trace)
            return dict(staged=[staged_run(mol, params) for _ in range(3)],
                        profile=profile)
        return measure
    if name in scored:
        params = scored[name]
        score = lambda: score_only(*port_tables(mol, params))  # noqa: E731
        score()

        def measure():
            profile = (profiled_one_kernel(score, trace)
                       if params.get("max_shift") == 0 else
                       profiled_run(score, n, m, trace))
            return dict(staged=[staged_score(mol, params) for _ in range(3)],
                        profile=profile)
        return measure
    if name.startswith("batch_"):
        base = name[len("batch_"):].removesuffix("_prepared")
        tables, _lengths, S, params, affine, quantum = \
            PROFILE_BATCHES[base](mol)
        kw = dict(affine=affine, bucket_quantum=quantum)
        if name.endswith("_prepared"):
            prep = pbatch.PreparedBatch(tables, S, params, **kw)
            prep.scores()
            return lambda: dict(profile_prepared=profiled_batch(prep.scores,
                                                                trace))
        run = lambda: pbatch.score_batch(tables, S, params, **kw)  # noqa
        run()

        def measure():
            profile = profiled_batch(run, trace)
            return dict(staged=[staged_batch(tables, S, params, affine,
                                             quantum) for _ in range(3)],
                        profile=profile)
        return measure
    if name.startswith("align_"):
        dispatch = realistic_dispatchers(mol, realistic_batch(mol))[
            name[len("align_"):]]
        dispatch().get()

        def measure():
            profile = profiled_align(lambda: dispatch().get(), trace)
            return dict(staged=[staged_align(dispatch) for _ in range(3)],
                        profile=profile)
        return measure
    if name in ("split_k4", "split_k4_resident"):
        route = "resident" if name.endswith("_resident") else "streams"
        fill = split_fill(mol, route)
        return lambda: profiled_split(fill, out, route)
    if name == "stream_alignments_codes":
        buffer_seconds(stream_corpus(mol), DNAPOL_FULL, alignments=True,
                       codes=True, serial=False)
        return lambda: profiled_stream(mol, out)
    raise ValueError(f"no profiled measurement {name!r}")


def spawn_profiles(names) -> list:
    """One process of this script for each of ``names`` (--profile-one),
    all started at once: each imports what it needs, loads the library,
    makes its measurement's tables and warm-up run (:func:`profile_setup`)
    and prepares its profiler (10-14 s, the slow part, all processes
    together), prints "ready", then waits for a line on its standard input,
    so that they measure one at a time, once all are ready
    (:func:`wait_ready`, :func:`profile_in_child`).  Each trace is then
    the first of its process: nothing of one trace (the profiler's or
    CUPTI's state) reaches another."""
    return [(name, subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--profile-one",
         name], cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for name in names]


def wait_ready(name: str, proc) -> None:
    """Wait until the process of measurement ``name`` has set up (its line
    "ready"; it prints nothing after it before its turn)."""
    for line in iter(proc.stdout.readline, ""):
        if line == "ready\n":
            return
    proc.kill()
    check(False, f"--profile-one {name} did not set up: "
          f"{proc.stderr.read()[-3000:]}")


def profile_in_child(name: str, proc) -> dict:
    """Start the set-up process of measurement ``name`` and return the
    result it prints last, with the seconds of its turn (``turn_s``, from
    the start signal to its exit); fails when the process does (a check
    that failed in it included)."""
    t0 = time.perf_counter()
    try:
        stdout, stderr = proc.communicate("go\n", timeout=600)
    finally:
        proc.kill()
    check(proc.returncode == 0, f"--profile-one {name} exit "
          f"{proc.returncode}: {stderr[-3000:]}")
    return dict(json.loads(stdout.strip().splitlines()[-1]),
                turn_s=time.perf_counter() - t0)


def profiled_in_children(names) -> dict:
    """name -> the result of its measurement, each in a process of its
    own, one after another; every process is ended before this returns."""
    procs = spawn_profiles(names)
    try:
        for name, proc in procs:
            wait_ready(name, proc)
        return {name: profile_in_child(name, proc) for name, proc in procs}
    finally:
        for _name, proc in procs:
            proc.kill()
            proc.wait()


def phase_profile(out: Path) -> dict:
    """Where the time goes in the DNA-Pol-1 runs, band path and score-only
    path, in the two batches of the batched-scores path (from host tables
    and from resident ones), in the realistic batch's alignments (from
    tables and from codes), in the split's K = 4 fill and in the codes
    stream: staged runs and one profiled run per configuration, after a
    warm-up run, each in a process of its own.  Returns the report, which
    also goes to ``out``/profile.json."""
    torch.cuda.empty_cache()            # the card's memory for the children
    out.mkdir(parents=True, exist_ok=True)
    found = profiled_in_children(profile_names())
    report = {}
    for name, result in found.items():
        key = name.removesuffix("_prepared")
        if key != name:
            result["turn_s_prepared"] = result.pop("turn_s")
        report[key] = dict(report.get(key, {}), **result)
    (out / "profile.json").write_text(json.dumps(report, indent=1))
    return report


def phase_profile_stress(mol, out: Path, in_process: bool) -> dict:
    """The stress phase: a large trace in this process (the split's K = 4
    fill twice, some 15,000 device events), then STRESS_TRACES traces of
    the DNA-Pol-1 band path, each in a process of its own, each of which
    must hold all n+m+1 DP kernels (profiled_run's check).  With
    ``in_process`` (--profile-stress) also STRESS_TRACES such traces in
    this process after the large one, whose counts are recorded and not
    checked (the condition under which the check once fell short, ROADMAP
    Queue 3), and two processes whose prepared session idles GAP_IDLE_S
    ("gap_idle") or sees a run on the card ("gap_busy") before its trace,
    their counts recorded."""
    torch.cuda.empty_cache()
    out.mkdir(parents=True, exist_ok=True)
    n, m = len(mol[0]), len(mol[2])
    gaps = ["gap_idle", "gap_busy"] if in_process else []
    procs = spawn_profiles(gaps + ["band_trace"] * STRESS_TRACES)
    try:
        fill = split_fill(mol)
        t0 = time.perf_counter()
        _summary, dev = traced(lambda: (fill(), fill()),
                               out / "trace_large.json")
        found = dict(large_trace_device_events=len(dev),
                     large_trace_s=time.perf_counter() - t0)
        if in_process:
            t0 = time.perf_counter()
            traced_here = []
            run_e2e(mol, DNAPOL_FULL)
            for k in range(STRESS_TRACES):
                _summary, dev = traced(lambda: run_e2e(mol, DNAPOL_FULL),
                                       out / f"trace_stress_{k}.json")
                traced_here.append(len(dp_kernel_stats(dev, ("_diag",))[0]))
            found.update(in_process_dp_kernels_traced=traced_here,
                         in_process_s=time.perf_counter() - t0)
        for name, proc in procs:
            wait_ready(name, proc)
        for name, proc in procs[:len(gaps)]:
            found[name] = profile_in_child(name, proc)
        if gaps:
            say("8 stress, prepared sessions", **{k: found[k] for k in gaps})
        t0 = time.perf_counter()
        fills = [profile_in_child(name, proc)
                 for name, proc in procs[len(gaps):]]
    finally:
        for _name, proc in procs:
            proc.kill()
            proc.wait()
    kernels = [f["kernels"] for f in fills]
    check(kernels == [n + m + 1] * STRESS_TRACES,
          f"the stress phase's traces hold {kernels} DP kernels")
    return dict(found, dp_kernels=n + m + 1, child_dp_kernels_traced=kernels,
                child_mean_us=[f["mean_us"] for f in fills],
                child_turn_s=[f["turn_s"] for f in fills],
                children_s=time.perf_counter() - t0)


# -- phase 5, stream: the streaming driver and its batch CLI -----------------

def stream_corpus(mol) -> list:
    """The 1024 realistic windows of seeds 0-15 (ids w<seed>-<k>) with a
    copy of the whole pair (full-<k>) before every 128th window."""
    seqA, strA, seqB, strB = mol
    windows = [w for seed in range(STREAM_SEEDS)
               for w in realistic_windows(mol, seed)]
    out = []
    for idx, w in enumerate(windows):
        if idx % STREAM_FULL_EVERY == 0:
            out.append(PairRecord(f"full-{idx // STREAM_FULL_EVERY}", seqA,
                                  seqB, strA, strB))
        out.append(PairRecord(f"w{idx // REALISTIC_PAIRS}-"
                              f"{idx % REALISTIC_PAIRS}", **w))
    return out


def record_tables(recs, params) -> list:
    """(mu1, mu2) of each record through BiAligner's host layers, each
    distinct pair built once."""
    built = {}
    for r in recs:
        key = (r.seqA, r.seqB, r.strA, r.strB)
        if key not in built:
            built[key] = host_tables(dict(seqA=r.seqA, seqB=r.seqB,
                                          strA=r.strA, strB=r.strB),
                                     params)[:2]
    return [built[r.seqA, r.seqB, r.strA, r.strB] for r in recs]


def read_spool(path) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def dispatch_bytes(recs, S: int, affine: bool) -> list:
    """(band bytes, table bytes) of each fill-and-walk dispatch that
    dispatch_align_batch[_codes] makes of one chunk ``recs``: buckets of
    STREAM_QUANTUM rows cut into _auto_chunk's pairs, each a band [B,
    d_max + 1, states, W, W, N+1] and its bucket's two tables [B, N+1,
    M+1], int32 (the tables path uploads a bucket's at once)."""
    buckets = {}
    for r in recs:
        n, m = len(r.seqA), len(r.seqB)
        key = (pbatch.quantize(n, STREAM_QUANTUM),
               pbatch.quantize(m, STREAM_QUANTUM))
        buckets.setdefault(key, []).append(n + m)
    W = 2 * S + 1
    states = pbatch.N_STATES if affine else 1
    out = []
    for (N, M), last in buckets.items():
        per = pbatch._auto_chunk(N, M, S, affine)
        for lo in range(0, len(last), per):
            part = last[lo:lo + per]
            out.append((len(part) * (max(part) + 1) * states * W * W
                        * (N + 1) * 4, 2 * len(last) * (N + 1) * (M + 1) * 4))
    return out


def peak_bounds(recs, S: int, affine: bool) -> dict:
    """The bytes an alignment stream of ``recs`` should hold at its peak.
    A dispatch drops its band once the walk is queued behind the fill, and
    the allocator hands the block on in stream order, so with two chunks in
    flight one band lives at a time: the peak lies between the largest band
    (``least``) and the largest band with its bucket's tables plus
    PEAK_MARGIN (``most``); ``two_chunks`` is what the bands and tables of
    two chunks would take if all of them lived at once."""
    chunks = [dispatch_bytes(recs[lo:lo + STREAM_CHUNK], S, affine)
              for lo in range(0, len(recs), STREAM_CHUNK)]
    each = [sum(band + tables for band, tables in c) for c in chunks]
    return dict(
        least=max(band for c in chunks for band, _tables in c),
        most=max(band + tables for c in chunks for band, tables in c)
        + PEAK_MARGIN,
        two_chunks=max(a + b for a, b in zip(each, each[1:] + [0])))


def stream_run(recs, params, spool: Path, *, alignments: bool,
               codes) -> tuple:
    """``recs`` through StreamingAligner on the card into a fresh ``spool``,
    double-buffered as it runs; returns (what run() yielded, report)."""
    if spool.exists():
        spool.unlink()
    sa = StreamingAligner(params, spool_path=str(spool),
                          chunk_pairs=STREAM_CHUNK,
                          bucket_quantum=STREAM_QUANTUM,
                          alignments=alignments, codes=codes)
    if codes != "auto":
        check((sa._codes_lut is not None) == codes, f"codes={codes} not taken")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = list(sa.run(recs))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sa.spool.close()
    peak = torch.cuda.max_memory_allocated()
    bounds = {}
    if alignments:
        bounds = peak_bounds(recs, sa.max_shift, sa.affine)
        check(bounds["least"] <= peak <= bounds["most"],
              f"stream peak {peak} B outside the predicted {bounds} B")
        bounds = {"peak_predicted_" + k: v for k, v in bounds.items()}
    rate = "alignments_per_s" if alignments else "pairs_per_s"
    return results, {
        "pairs": len(results), rate: len(results) / seconds,
        "seconds": seconds, "dispatch_host_s": sa.dispatch_seconds,
        "codes": sa._codes_lut is not None, "stats": json.loads(
            sa.stats.to_json()),
        "max_memory_allocated": peak, **bounds,
        "card_memory": torch.cuda.get_device_properties(0).total_memory}


def buffer_seconds(recs, params, *, alignments: bool, codes,
                   serial: bool) -> tuple:
    """StreamingAligner's chunks without a spool, double-buffered as run()
    takes them or ``serial``: run() on one chunk at a time, so each is
    waited for and harvested before the next is built.  Returns (seconds,
    host seconds of the dispatches)."""
    sa = StreamingAligner(params, chunk_pairs=STREAM_CHUNK,
                          bucket_quantum=STREAM_QUANTUM,
                          alignments=alignments, codes=codes)
    parts = ([recs[lo:lo + STREAM_CHUNK]
              for lo in range(0, len(recs), STREAM_CHUNK)]
             if serial else [recs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for part in parts:
        for _ in sa.run(part):
            pass
    torch.cuda.synchronize()
    return time.perf_counter() - t0, sa.dispatch_seconds


def check_stream(results, spooled, recs, want, what: str) -> None:
    """A run's results and spool against score_batch (``want`` = scores)
    or align_batch (``want`` = (scores, traces, complete)), pair by pair in
    stream order."""
    aligned = isinstance(want, tuple)
    scores = want[0] if aligned else want
    check([r[0] for r in results] == [r.id for r in recs],
          f"{what}: ids out of stream order")
    check([r[1] for r in results] == np.asarray(scores).tolist(),
          f"{what}: scores differ from the batch path's")
    check([(x["id"], x["score"]) for x in spooled]
          == [(r.id, int(s)) for r, s in zip(recs, scores)],
          f"{what}: spool differs")
    if aligned:
        for idx, (res, rec) in enumerate(zip(results, spooled)):
            check(res[2] == want[1][idx], f"{what}: trace of {res[0]}")
            check(rec["trace"] == trace_to_codes(want[1][idx]),
                  f"{what}: spooled trace of {res[0]}")
            check(rec["complete"] == bool(want[2][idx]),
                  f"{what}: complete flag of {res[0]}")


def check_full_copies(results, full_aligner, md5, what: str) -> int:
    """Every full-<k> record: SCORE 761500 and, for alignments, the six md5
    anchors of its lines; returns how many there were."""
    found = [r for r in results if r[0].startswith("full-")]
    for r in found:
        check(r[1] == 761500, f"{what}: {r[0]} scored {r[1]}")
        if len(r) == 3:
            got = md5_anchors(full_aligner.decode_trace(r[2]))
            check(got == md5, f"{what}: {r[0]} md5 anchors {got}")
    return len(found)


def write_tsv(path: Path, recs) -> None:
    path.write_text("".join(
        f"{r.id}\t{r.seqA}\t{r.seqB}\t{r.strA}\t{r.strB}\n" for r in recs))


def cli_args(params) -> list:
    """The batch CLI's flags for ``params``."""
    return [x for k, v in params.items() for x in (f"--{k}", str(v))]


def run_module(args, env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, what: str, timeout=300) -> str:
    """Wait for ``proc``; its standard output, or raise with its errors."""
    out, err = proc.communicate(timeout=timeout)
    check(proc.returncode == 0, f"{what}: rc {proc.returncode}\n"
          f"{err[-3000:]}")
    return out


def stream_two_processes(recs, params, where: Path) -> dict:
    """The batch CLI in two processes on the one card (RANK 0/1,
    WORLD_SIZE 2) over a TSV of ``recs``: disjoint shards whose merge is
    the one-process spool."""
    tsv = where / "two.tsv"
    write_tsv(tsv, recs)
    spool = where / "two.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    t0 = time.perf_counter()
    procs = [run_module(["bialign_tpu_torch.parallel.batch_cli", str(tsv),
                         "--spool", str(spool), "--distributed",
                         *cli_args(params)],
                        env=dict(env, RANK=str(rank), WORLD_SIZE="2"))
             for rank in range(2)]
    for rank, proc in enumerate(procs):
        finish(proc, f"batch_cli RANK {rank}")
    seconds = time.perf_counter() - t0
    shards = [Path(f"{spool}.shard{rank}") for rank in range(2)]
    ids = [{x["id"] for x in read_spool(p)} for p in shards]
    check(not ids[0] & ids[1], "the two processes' shards overlap")
    check(ids[0] | ids[1] == {r.id for r in recs}, "the shards miss pairs")
    one = where / "one.jsonl"
    stream_run(recs, params, one, alignments=False, codes="auto")
    check(merge_spools([str(p) for p in shards]) == merge_spools([str(one)]),
          "the merged shards differ from one process's spool")
    return dict(pairs=len(recs), shard_pairs=[len(x) for x in ids],
                seconds_both=seconds,
                device_count=torch.cuda.device_count(),
                merged_equal_to_one_process=True)


def stream_render(recs, params, where: Path) -> dict:
    """batch_cli --alignments --render: every line equal to BiAligner's
    decode of the same pair."""
    tsv = where / "render.tsv"
    write_tsv(tsv, recs)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = batch_cli.main([str(tsv), "--alignments", "--render",
                             *cli_args(params)])
    check(rc == 0, f"batch_cli --render rc {rc}")
    want = []
    for r in recs:
        ba = BiAligner(r.seqA, r.seqB, r.strA, r.strB, nameA=f"{r.id}.A",
                       nameB=f"{r.id}.B", **params)
        score = ba.optimize()
        want.append(json.dumps({"id": r.id, "score": score,
                                "trace": trace_to_codes(ba.traceback())}))
        want += list(ba.decode_trace())
    check(out.getvalue().splitlines() == want,
          "batch_cli --render differs from BiAligner's lines")
    return dict(pairs=len(recs), lines=len(want), equal_to_bialigner=True)


def stream_warmup() -> dict:
    """The warmup module in a fresh process: rc 0 and its timings."""
    t0 = time.perf_counter()
    out = finish(run_module([
        "bialign_tpu_torch.utils.warmup", "--lengths", "512x512", "960x960",
        "--max-shift", "1", "--traceback", "--streaming",
        "--streaming-batch", str(STREAM_CHUNK), "--gap_opening_cost",
        str(DNAPOL_FULL["gap_opening_cost"]), "--gap_cost",
        str(DNAPOL_FULL["gap_cost"]), "--shift_cost",
        str(DNAPOL_FULL["shift_cost"]), "--structure_weight",
        str(DNAPOL_FULL["structure_weight"])]), "warmup")
    lines = out.splitlines()
    check(lines and lines[-1].startswith("prewarm total"),
          f"warmup printed {lines[-3:]}")
    return dict(process_s=time.perf_counter() - t0, lines=lines)


def stream_double_buffer(mol) -> dict:
    """The share of a chunk's host work that the double buffer hides: the
    corpus's alignments without a spool, serial and double-buffered in
    turns (from tables once each: the host's table build, about eight times
    the device's work, decides those).  Run with --stream-only."""
    corpus = stream_corpus(mol)
    hidden = {}
    for codes in (False, True):
        got = {"serial": [], "double": []}
        host = []
        for serial in (True, False, False, True)[:4 if codes else 2]:
            seconds, dispatch_s = buffer_seconds(
                corpus, DNAPOL_FULL, alignments=True, codes=codes,
                serial=serial)
            got["serial" if serial else "double"].append(seconds)
            host.append(dispatch_s)
        saved = min(got["serial"]) - min(got["double"])
        hidden["codes" if codes else "tables"] = dict(
            serial_s=got["serial"], double_buffered_s=got["double"],
            dispatch_host_s=host, hidden_s=saved,
            hidden_share_of_host=saved / min(host),
            alignments_per_s=len(corpus) / min(got["double"]))
    return hidden


def profiled_stream(mol, out: Path) -> dict:
    """Where the codes stream's time goes: the device's busy time in the
    window of one double-buffered run of the corpus's alignments (its
    trace is the largest, about 30,000 device events)."""
    out.mkdir(parents=True, exist_ok=True)
    summary, _dev = traced(
        lambda: buffer_seconds(stream_corpus(mol), DNAPOL_FULL,
                               alignments=True, codes=True, serial=False),
        out / "trace_stream_alignments_codes.json")
    return {k: v for k, v in summary.items() if k != "kernels"}


def phase_stream(mol, md5, smi) -> tuple[dict, dict]:
    """The streaming driver on the card: the corpus's four runs (scores and
    alignments, from tables and from codes; the alignments' peak memory
    against peak_bounds), the non-affine CLI defaults, 512 toy
    pairs at max_shift 1 and 0, and a resume after a cut spool, all
    counted; then each against score_batch / align_batch, two batch CLI
    processes, --render and the warmup.  Returns (report, launches of the
    StreamingAligner runs)."""
    t_phase = time.perf_counter()
    where = ROOT / "build" / "stream"
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    seqA, strA, seqB, strB = mol
    full_aligner = BiAligner(seqA, seqB, strA, strB, **DNAPOL_FULL)
    corpus = stream_corpus(mol)
    windows = [r for r in corpus if not r.id.startswith("full-")]
    subset = windows[:STREAM_SUBSET]
    toy = [PairRecord(f"toy-{k}", **TOY) for k in range(TOY_PAIRS)]
    toy_ms0 = dict(DNAPOL_FULL, max_shift=0)
    runs, found = {}, {}

    def run(name, recs, params, **kw):
        results, report = stream_run(recs, params, where / f"{name}.jsonl",
                                     **kw)
        runs[name] = results
        say("5 stream run", nvidia_smi=smi, run=name, **report,
            phase_s=time.perf_counter() - t_phase)
        found[name] = report

    # the StreamingAligner runs, counted apart
    reset_counts()
    for alignments in (False, True):
        for codes in (False, True):
            name = (("alignments" if alignments else "scores")
                    + ("_codes" if codes else "_tables"))
            run(name, corpus, DNAPOL_FULL, alignments=alignments, codes=codes)
    for alignments in (False, True):
        run("nonaffine_" + ("alignments" if alignments else "scores"), subset,
            DNAPOL_CLI_DEFAULTS, alignments=alignments, codes="auto")
    run("toy_ms1", toy, DNAPOL_FULL, alignments=False, codes="auto")
    run("toy_ms0", toy, toy_ms0, alignments=False, codes="auto")
    # resume: half the corpus, the spool's last line cut in half, the whole
    resumed = where / "resume.jsonl"
    half = corpus[:len(corpus) // 2]
    stream_run(half, DNAPOL_FULL, resumed, alignments=False, codes=True)
    data = resumed.read_bytes()
    last = data.rstrip(b"\n").rfind(b"\n") + 1
    cut = last + (len(data) - last) // 2
    resumed.write_bytes(data[:cut])
    sa = StreamingAligner(DNAPOL_FULL, spool_path=str(resumed),
                          chunk_pairs=STREAM_CHUNK,
                          bucket_quantum=STREAM_QUANTUM, codes=True)
    again = list(sa.run(corpus))
    sa.spool.close()
    launches = path_counts("stream")

    # against the batch path on the same records
    costs = (DNAPOL_FULL["gap_opening_cost"], DNAPOL_FULL["gap_cost"],
             DNAPOL_FULL["shift_cost"])
    tables = record_tables(corpus, DNAPOL_FULL)
    kw = dict(affine=True, bucket_quantum=STREAM_QUANTUM)
    want_scores = pbatch.score_batch(tables, 1, costs, **kw)
    want_aligned = pbatch.align_batch(tables, 1, costs, **kw)
    check(want_aligned[0].tolist() == want_scores.tolist(),
          "align_batch scores differ from score_batch's")
    for name in ("scores_tables", "scores_codes", "alignments_tables",
                 "alignments_codes"):
        want = want_aligned if name.startswith("alignments") else want_scores
        check_stream(runs[name], read_spool(where / f"{name}.jsonl"), corpus,
                     want, name)
        found[name]["full_copies"] = check_full_copies(
            runs[name], full_aligner, md5, name)
        found[name]["equal_to_batch_path"] = True
    na = BiAligner(**TOY, **DNAPOL_CLI_DEFAULTS)
    na_params = (na.gamma, na.delta)
    tables = record_tables(subset, DNAPOL_CLI_DEFAULTS)
    kw = dict(affine=False, bucket_quantum=STREAM_QUANTUM)
    check_stream(runs["nonaffine_scores"],
                 read_spool(where / "nonaffine_scores.jsonl"), subset,
                 pbatch.score_batch(tables, na.max_shift, na_params, **kw),
                 "nonaffine_scores")
    check_stream(runs["nonaffine_alignments"],
                 read_spool(where / "nonaffine_alignments.jsonl"), subset,
                 pbatch.align_batch(tables, na.max_shift, na_params, **kw),
                 "nonaffine_alignments")
    tables = record_tables(toy[:1], DNAPOL_FULL) * TOY_PAIRS
    for name, params in (("toy_ms1", DNAPOL_FULL), ("toy_ms0", toy_ms0)):
        want = pbatch.score_batch(tables, params["max_shift"], costs,
                                  affine=True, bucket_quantum=STREAM_QUANTUM)
        check_stream(runs[name], read_spool(where / f"{name}.jsonl"), toy,
                     want, name)
    check(set(x[1] for x in runs["toy_ms1"]) == {TOY_SCORE},
          "toy pairs at max_shift 1 are not all 48500")

    spooled = read_spool(resumed)
    ids = [x["id"] for x in spooled]
    check(len(ids) == len(set(ids)) == len(corpus),
          f"resumed spool: {len(ids)} records, {len(set(ids))} ids")
    check(merge_spools([str(resumed)])
          == merge_spools([str(where / "scores_codes.jsonl")]),
          "the resumed spool differs from a one-shot run's")
    found["resume"] = dict(first_run=len(half), cut_at_byte=cut,
                           second_run=len(again), spool_records=len(ids),
                           equal_to_one_shot=True)

    found["two_processes"] = stream_two_processes(subset, DNAPOL_FULL, where)
    found["render"] = stream_render(windows[:STREAM_RENDER], DNAPOL_FULL,
                                    where)
    found["warmup"] = stream_warmup()
    found["phase_s"] = time.perf_counter() - t_phase
    return found, launches


# -- phase 5, triplet: the triplet aligner's fill on its kernel --------------

def triplet_cases() -> list:
    """(n, m, max_shift, tables) of phase 3's triplet fills: each length
    of TRIPLET_LENGTHS against two others, max_shift 0-4 in turn; an empty
    pair; max_shift beyond the compiled widths; tie-heavy tables and
    tables whose sums wrap int32."""
    L, k = TRIPLET_LENGTHS, len(TRIPLET_LENGTHS)
    out = [(n, L[(a + 5) % k], a % 5, "random") for a, n in enumerate(L)]
    out += [(n, L[k - 1 - a], (a + 2) % 5, "random")
            for a, n in enumerate(L)]
    beyond = TRIPLET_STATIC_SHIFTS + 1
    out += [(0, 0, 1, "random"), (1023, 1024, 1, "random"),
            (65, 63, beyond, "random"),
            (2, 33, beyond + 3, "random"), (65, 64, 1, "ties"),
            (1025, 1024, 2, "ties"), (64, 65, 1, "wrap"),
            (31, 33, beyond, "wrap")]
    return out


def triplet_tables(rng, n, m, kind: str):
    """Tables [n+1, m+1] int32 (row and column 0 zero, as the host's):
    values in [-400, 900) (tests/test_triplet.py's), in {0, +-100}, or of
    magnitude 2^29 to 2^31 - 1, either sign."""
    mu = np.zeros((2, n + 1, m + 1), dtype=np.int64)
    if kind == "random":
        mu[:, 1:, 1:] = rng.integers(-400, 900, size=(2, n, m))
    elif kind == "ties":
        mu[:, 1:, 1:] = rng.integers(-1, 2, size=(2, n, m)) * 100
    else:
        mu[:, 1:, 1:] = (rng.integers(1 << 29, (1 << 31) - 1, size=(2, n, m))
                         * rng.choice([-1, 1], size=(2, n, m)))
    return mu[0].astype(np.int32), mu[1].astype(np.int32)


def triplet_err(got, want, junk, n: int, m: int, S: int) -> int:
    """Max |difference| of the kernel's slabs from the twin's on the
    domain and from the garbage it started on everywhere else."""
    live = trip.domain(n, m, S, got.device)
    return int((got.long() - torch.where(live, want, junk).long())
               .abs().max())


def phase_triplet_kernels(dev, errs: dict) -> list:
    """The triplet fill's kernels against the twin (on the CPU) on slabs of
    garbage, at triplet_cases(): route "global" everywhere and route
    "shared" wherever triplet_route gives it (elsewhere a forced "shared"
    must raise), both at TRIPLET_THREADS; route "cluster" on each of
    TRIPLET_CLUSTERS CTAs wherever cluster_shape holds the pair (elsewhere
    a forced "cluster" must raise); route "resident" on its own CTAs and on
    3.  Returns the cases with, for each thread count, then each cluster
    size, then each resident grid, the routes run."""
    rng = np.random.default_rng(SEED)
    ran = []

    def refused(what, **kw):
        try:
            trip.fill_slabs_cuda(mu1, mu2, S, gamma, delta, device=dev, **kw)
        except ValueError:
            return
        raise RuntimeError(f"triplet ({n}, {m}, {S}): a forced {what} that "
                           "does not fit did not raise")

    def held(**kw):
        junk = garbage_band(want.shape, dev)
        got = trip.fill_slabs_cuda(mu1, mu2, S, gamma, delta, device=dev,
                                   ys=junk.clone(), **kw)
        e = triplet_err(got, want, junk, n, m, S)
        name = f"triplet_fill_{kw['route']}"
        check(e == 0, f"{name} ({n}, {m}, {S}, {kind}, {kw}): max |err| {e}")
        errs[name] = max(errs[name], e)

    for n, m, S, kind in triplet_cases():
        mu1, mu2 = triplet_tables(rng, n, m, kind)
        gamma, delta = TRIPLET_COSTS[kind]
        want = trip.fill_slabs(mu1, mu2, S, gamma, delta,
                               device="cpu").to(dev)
        routes_of = []
        for threads in TRIPLET_THREADS:
            routes = ("shared", "global")
            if trip.triplet_route(n, S, threads) != "shared":
                routes = ("global",)
                refused("'shared'", threads=threads, route="shared")
            for route in routes:
                held(threads=threads, route=route)
            routes_of.append("+".join(routes))
        for C in TRIPLET_CLUSTERS:
            if trip.cluster_shape(n, S, C) is None:
                refused(f"'cluster' of {C}", route="cluster", cluster=C)
                routes_of.append("-")
            else:
                held(route="cluster", cluster=C)
                routes_of.append(f"cluster{C}")
        for G in TRIPLET_RESIDENT_CTAS:
            held(route="resident", ctas=G)
            routes_of.append(f"resident{trip.resident_shape(n, S, G)[0]}")
        ran.append((n, m, S, kind, *routes_of))
    return ran


def triplet_outputs(ba) -> tuple:
    """Score, trace, the three rows, the six with structures and the
    eval_trace lines of one triplet aligner."""
    score = ba.optimize()
    trace = ba.traceback()
    return (score, trace, ba.decode_trace(trace),
            ba.decode_trace(trace, show_structures=True),
            list(ba.eval_trace(trace)))


def triplet_bound(n: int, m: int, S: int, cells: int):
    """Bound of one triplet fill: the two tables read once, the domain's
    ``cells`` written once, TRIPLET_OPS_PER_CELL operations a cell."""
    return bound(2 * (n + 1) * (m + 1) * 4 + cells * 4,
                 cells * TRIPLET_OPS_PER_CELL)


def triplet_launcher(route, mu1, mu2, S, gamma, delta, dev, threads=None,
                     cluster=None):
    """(call, ys): one launch of route's kernel alone (route "cluster" on
    ``cluster`` CTAs, default cluster_shape's; route "resident" on a grid
    of ``cluster`` CTAs, default resident_shape's, its flags zeroed before
    each launch), on tables laid out once as fill_slabs_cuda lays them out,
    through the C entry (so not counted), for timing."""
    n, m = mu1.shape[0] - 1, mu1.shape[1] - 1
    more = ()
    if route == "cluster":
        cluster, threads, _ = trip.cluster_shape(n, S, cluster, threads)
        more = (cluster,)
    elif route == "resident":       # `cluster` is the grid's CTAs here
        G, threads, _ = trip.resident_shape(n, S, cluster, threads)
        halo = (torch.empty((G - 1, n + m + 1, 2 * S + 1), dtype=torch.int32,
                            device=dev) if G > 1 else None)
        flags = torch.zeros(G, dtype=torch.int32, device=dev)
        more = (G, halo, flags, cuda_dp.fault_word())
    elif threads is None:
        threads = trip.default_threads(n)
    if route == "global":
        t1, t2 = (torch.as_tensor(mu).to(device=dev, dtype=torch.int32)
                  .contiguous() for mu in (mu1, mu2))
    else:
        t1, t2 = trip.shared_tables(mu1, mu2, S, dev)
    ys = torch.empty((n + m + 1, n + 1, 2 * S + 1), dtype=torch.int32,
                     device=dev)
    name = {"shared": "bialign_triplet_fill_shared",
            "cluster": "bialign_triplet_fill_cluster",
            "resident": "bialign_triplet_fill_resident",
            "global": "bialign_triplet_fill"}[route]
    args = (ys, t1, t2, n, m, S, trip._int32(2 * gamma),
            trip._int32(gamma + delta), threads, *more)
    if route == "resident":         # its flags zeroed before each launch
        def call():
            more[2].zero_()
            _build.launch(name, dev, *args)
        return call, ys
    return (lambda: _build.launch(name, dev, *args)), ys


def triplet_aligner(pair, **params):
    seqA, strA, seqB, strB = pair
    return BiAlignerTriplet(seqA, seqB, strA, strB, **params)


def triplet_stages(ba, dev) -> dict:
    """optimize()'s stages, TRIPLET_RUNS times, each on the host clock
    closed by a device sync: the tables' upload, the kernel (on its
    default route), the slabs' copy back (ys.cpu()), and _BandCells with
    the traceback (the first-match walk on the host)."""
    found = {k: [] for k in ("upload_ms", "kernel_ms", "copy_back_ms",
                             "band_cells_and_traceback_ms")}
    p = (ba.max_shift, ba.gamma, ba.delta)

    def upload():
        return [torch.as_tensor(mu).to(device=dev, dtype=torch.int32)
                .contiguous() for mu in (ba.mu1, ba.mu2)]

    def walk(host):
        ba.M = trip._BandCells(host, ba.max_shift)
        return ba.traceback()

    for _ in range(TRIPLET_RUNS):
        s_up, (t1, t2) = timed(upload)
        s_fill, ys = timed(lambda: trip.fill_slabs_cuda(t1, t2, *p,
                                                        device=dev))
        s_copy, host = timed(lambda: ys.cpu().numpy())
        s_walk, _ = timed(lambda: walk(host))
        for key, sec in zip(found, (s_up, s_fill, s_copy, s_walk)):
            found[key].append(sec * 1e3)
    found["slab_bytes"] = int(ys.numel()) * 4
    return found


def triplet_turns(launch: dict, runs: int) -> dict:
    """{name: [ms of each run]} of the launchers (CUDA events, warm), in
    turns: the names in order, then in reverse, ``runs`` times."""
    found = {name: [] for name in launch}
    order = list(launch) + list(launch)[::-1]
    for _ in range(runs):
        for name in order:
            found[name].append(cuda_ms(launch[name], 1)[0])
    return found


def triplet_grown(mol, n: int, m: int) -> tuple:
    """(seqA, strA, seqB, strB) of n and m residues: each DNA-Pol-1
    sequence and structure continued by its own start."""
    def grow(text, k):
        return (text * (k // len(text) + 1))[:k]

    seqA, strA, seqB, strB = mol
    return grow(seqA, n), grow(strA, n), grow(seqB, m), grow(strB, m)


def triplet_big_pair(mol) -> tuple:
    """(seqA, strA, seqB, strB) of TRIPLET_BIG's lengths."""
    return triplet_grown(mol, *TRIPLET_BIG[:2])


def slabs_err_on_domain(got, ys, n: int, m: int, S: int) -> int:
    """Max |difference| on the domain of slabs ``got`` (numpy on the host,
    or a tensor) from ``ys`` (on the card), a thousand diagonals at a
    time."""
    e = 0
    for d0 in range(0, n + m + 1, 1000):
        d1 = min(n + m + 1, d0 + 1000)
        part = torch.as_tensor(got[d0:d1]).to(ys.device)
        d = torch.arange(d0, d1, device=ys.device)[:, None, None]
        i = torch.arange(n + 1, device=ys.device)[None, :, None]
        k = d - i + torch.arange(2 * S + 1, device=ys.device) - S
        live = (d - i >= 0) & (d - i <= m) & (k >= 0) & (k <= m)
        diff = (part.long() - ys[d0:d1].long()).abs() * live
        e = max(e, int(diff.max()))
    return e


def phase_triplet(mol, dev, errs: dict) -> tuple:
    """The triplet aligner through its default engine, the CUDA kernel
    (counted launches): the DNA-Pol-1 pair at max_shift 1 (route "shared":
    score TRIPLET_DNAPOL_SCORE, and score, trace, rows, rows with
    structures and eval_trace lines equal to the plain twin's on the CPU),
    the TRIPLET_BIG pair at max_shift 8 (its own route, triplet_route's) and
    the TRIPLET_HUGE pair (route "resident", beyond any portable cluster),
    run once: its slabs equal to route "global"'s forced on the domain, its
    score to that route's last cell; and TRIPLET_BIG's fill forced onto the
    routes that are not its own through fill_slabs_cuda.  Then, not
    counted: at DNA-Pol-1 the slabs of every route (route "cluster" on
    each of TRIPLET_DNAPOL_CLUSTERS CTAs, "resident" on its own CTAs) equal
    to the twin's on the card on the domain; at TRIPLET_BIG the aligner's
    slabs and every route's (route "cluster" on each of
    TRIPLET_BIG_CLUSTERS CTAs, 16 where the card makes such a cluster
    resident) equal to the twin's on the card, and the aligner's score to
    the twin's cell; each route's time (CUDA events, warm, in turns) beside
    the twin's on the card and on the CPU, the bounds, the chain floors
    (one L2 load a diagonal, csrc/probe.cu, for "global"; "shared" on a
    pair of one row, whose diagonals are a barrier, the shared loads and
    the W-step chain alone); "resident" and "global" in turns at
    TRIPLET_HUGE; "resident" and "cluster" in turns at
    TRIPLET_ROUTE_SHAPES; optimize()'s stages at DNA-Pol-1 and at
    TRIPLET_BIG; the kernel on a 200 x 200 window against fill_oracle in
    every banded cell.  Returns (report, launches, {kernel: (ms, twin
    ms)}, {kernel: bound})."""
    big = triplet_big_pair(mol)
    big_params = dict(TRIPLET_PARAMS, max_shift=TRIPLET_BIG[2])
    bn, bm, bS = TRIPLET_BIG
    hn, hm, hS = TRIPLET_HUGE
    big_route = trip.triplet_route(bn, bS)
    huge = triplet_grown(mol, hn, hm)
    reset_counts()
    seconds, (ba, got) = timed(lambda: (lambda bt: (
        bt, triplet_outputs(bt)))(triplet_aligner(mol, **TRIPLET_PARAMS)))
    big_s, (bb, big_got) = timed(lambda: (lambda bt: (
        bt, triplet_outputs(bt)))(triplet_aligner(big, **big_params)))
    bp = (bS, bb.gamma, bb.delta)
    forced = {route: trip.fill_slabs_cuda(bb.mu1, bb.mu2, *bp, device=dev,
                                          route=route)
              for route in ("cluster", "resident", "global")
              if route != big_route}
    huge_s, (hb, huge_got) = timed(lambda: (lambda bt: (
        bt, triplet_outputs(bt)))(triplet_aligner(
            huge, **dict(TRIPLET_PARAMS, max_shift=hS))))
    hp = (hS, hb.gamma, hb.delta)
    huge_global = trip.fill_slabs_cuda(hb.mu1, hb.mu2, *hp, device=dev,
                                       route="global")
    launches = path_counts("triplet")
    check(trip.triplet_route(len(mol[0]), ba.max_shift) == "shared"
          and big_route in ("cluster", "resident")
          and trip.triplet_route(hn, hS) == "resident",
          "the triplet pairs' routes")
    check(got[0] == TRIPLET_DNAPOL_SCORE, f"triplet DNA-Pol-1 score "
          f"{got[0]}, not {TRIPLET_DNAPOL_SCORE}")
    ref = triplet_aligner(mol, engine="torch", device="cpu", **TRIPLET_PARAMS)
    cpu_s, _ = timed(ref.optimize)
    check(got == triplet_outputs(ref), f"triplet on the kernel (score "
          f"{got[0]}) differs from the twin on the CPU")
    # the pair beyond any portable cluster: its slabs (copied back by
    # optimize()) against route "global"'s on the domain, its score against
    # that route's last cell; then its kernel and "global" alone, in turns
    e = slabs_err_on_domain(hb.M.ys, huge_global, hn, hm, hS)
    check(e == 0, f"triplet_fill_resident at {TRIPLET_HUGE}: max |err| {e} "
          "from route 'global'")
    check(huge_got[0] == int(huge_global[hn + hm, hn, hS]),
          f"triplet at {TRIPLET_HUGE}: score {huge_got[0]} differs from "
          "route 'global''s last cell")
    errs["triplet_fill_resident"] = max(errs["triplet_fill_resident"], e)
    errs["triplet_fill_global"] = max(errs["triplet_fill_global"], e)
    huge_slab_bytes = int(huge_global.numel()) * 4
    j = np.arange(hm + 1)
    huge_cells = (hn + 1) * int((np.minimum(hm, j + hS)
                                 - np.maximum(0, j - hS) + 1).sum())
    del huge_global, hb

    optimize_s = [timed(ba.optimize)[0] for _ in range(3)]
    stages = triplet_stages(ba, dev)
    n, m, S = len(mol[0]), len(mol[2]), ba.max_shift
    t1, t2 = tables_to_torch(ba.mu1, ba.mu2, dev)
    p = (S, ba.gamma, ba.delta)
    plain_ms, twin = cuda_ms(lambda: trip.fill_slabs(ba.mu1, ba.mu2, *p,
                                                     device=dev), 1)
    live = trip.domain(n, m, S, dev)
    ys = {route: trip.fill_slabs_cuda(t1, t2, *p, device=dev, route=route)
          for route in trip.ROUTES}
    # the kernels alone, in turns; route "shared" also staged (480 threads,
    # two rows a thread: the tables in shared memory), route "cluster" on
    # each of TRIPLET_DNAPOL_CLUSTERS CTAs
    launch = {route: triplet_launcher(route, ba.mu1, ba.mu2, *p, dev)
              for route in ("global", "shared", "resident")}
    launch["staged"] = triplet_launcher("shared", ba.mu1, ba.mu2, *p, dev,
                                        threads=TRIPLET_STAGED_THREADS)
    for C in TRIPLET_DNAPOL_CLUSTERS:
        launch[f"cluster{C}"] = triplet_launcher(
            "cluster", ba.mu1, ba.mu2, *p, dev, cluster=C)
    for call, _ in launch.values():
        call()
    for route, slabs in [*ys.items(), *((r, v[1]) for r, v in launch.items())]:
        name = ("triplet_fill_" + ("shared" if route == "staged" else
                                   "cluster" if route.startswith("cluster")
                                   else route))
        e = int((slabs.long() - twin.long())[live].abs().max())
        check(e == 0, f"{name} ({route}) at DNA-Pol-1: max |err| {e}")
        errs[name] = max(errs[name], e)
    kernel_ms = triplet_turns({r: v[0] for r, v in launch.items()},
                              TRIPLET_RUNS)
    wrapper_ms = {route: min(cuda_ms(lambda: trip.fill_slabs_cuda(
        t1, t2, *p, device=dev, ys=ys[route], route=route), 1)[0]
        for _ in range(3)) for route in trip.ROUTES}
    cells = int(live.sum())
    del ys, twin, live, launch

    # the pair beyond one CTA: the aligner's route, the others forced, and
    # route "cluster" on each of TRIPLET_BIG_CLUSTERS CTAs
    b1, b2 = tables_to_torch(bb.mu1, bb.mu2, dev)
    big_plain_ms, big_twin = cuda_ms(lambda: trip.fill_slabs(
        bb.mu1, bb.mu2, *bp, device=dev), 1)
    big_live = trip.domain(bn, bm, bS, dev)
    big_launch = {route: triplet_launcher(route, bb.mu1, bb.mu2, *bp, dev)
                  for route in ("global", "resident")}
    not_resident = {}
    big_C = trip.cluster_shape(bn, bS)[0]       # the route's own
    for C in sorted({*TRIPLET_BIG_CLUSTERS, big_C}):
        call, slabs = triplet_launcher("cluster", bb.mu1, bb.mu2, *bp, dev,
                                       cluster=C)
        try:
            call()
        except RuntimeError as exc:
            # a cluster beyond the portable 8 CTAs that the card cannot
            # make resident is refused before its launch, by design
            if C <= trip.CLUSTER_PORTABLE:
                raise
            not_resident[C] = str(exc)
            continue
        big_launch[f"cluster{C}"] = (call, slabs)
    for route in ("global", "resident"):
        big_launch[route][0]()
    for route, slabs in [
            (big_route, torch.from_numpy(bb.M.ys).to(dev)),
            *forced.items(),
            *((r, v[1]) for r, v in big_launch.items())]:
        name = "triplet_fill_" + ("cluster" if route.startswith("cluster")
                                  else route)
        e = int((slabs.long() - big_twin.long())[big_live].abs().max())
        check(e == 0, f"{name} ({route}) at {TRIPLET_BIG}: max |err| {e}")
        errs[name] = max(errs[name], e)
    check(big_got[0] == int(big_twin[bn + bm, bn, bS]),
          f"triplet at {TRIPLET_BIG}: score {big_got[0]} differs from the "
          "twin's last cell")
    big_ms = triplet_turns({r: v[0] for r, v in big_launch.items()}, 3)
    big_cells = int(big_live.sum())
    del forced, big_twin, big_live, big_launch
    big_optimize_s = [timed(bb.optimize)[0] for _ in range(3)]
    big_stages = triplet_stages(bb, dev)
    del bb

    # "resident" and "global" alone at TRIPLET_HUGE, in turns (its tables
    # random: the kernels' time does not depend on the values)
    rng = np.random.default_rng(SEED + hn)
    h1, h2 = triplet_tables(rng, hn, hm, "random")
    huge_launch = {route: triplet_launcher(route, h1, h2, *hp, dev)
                   for route in ("resident", "global")}
    for call, _ in huge_launch.values():
        call()
    e = slabs_err_on_domain(huge_launch["resident"][1],
                            huge_launch["global"][1], hn, hm, hS)
    check(e == 0, f"triplet_fill_resident at {TRIPLET_HUGE}, random tables: "
          f"max |err| {e} from route 'global'")
    huge_ms = triplet_turns({r: v[0] for r, v in huge_launch.items()}, 2)
    del huge_launch

    # "resident" and "cluster" (its own C) in turns at the low end of
    # route "cluster"'s range, equal to each other on the domain
    route_ms = {}
    for rn, rm, rS in TRIPLET_ROUTE_SHAPES:
        r1, r2 = triplet_tables(np.random.default_rng(SEED + rn), rn, rm,
                                "random")
        pair = {route: triplet_launcher(route, r1, r2, rS, *TRIPLET_COSTS[
            "random"], dev) for route in ("cluster", "resident")}
        for call, _ in pair.values():
            call()
        rl = trip.domain(rn, rm, rS, dev)
        e = int((pair["cluster"][1].long() - pair["resident"][1].long())
                [rl].abs().max())
        check(e == 0, f"triplet_fill_resident at {(rn, rm, rS)}: max |err| "
              f"{e} from route 'cluster'")
        turns = triplet_turns({r: v[0] for r, v in pair.items()}, 3)
        route_ms[f"{rn}x{rm} max_shift {rS}"] = dict(
            shapes=dict(cluster=trip.cluster_shape(rn, rS),
                        resident=trip.resident_shape(rn, rS)),
            ms_min_max={r: (min(v), max(v)) for r, v in turns.items()},
            us_per_diagonal={r: min(v) * 1e3 / (rn + rm + 1)
                             for r, v in turns.items()})
        del pair, rl

    # the chain floors: one L2 load a diagonal; a pair of one row on
    # "shared", at DNA-Pol-1's threads
    l2_ns = chain_latency(dev)["ns_per_load_l2"]
    fm = TRIPLET_FLOOR_M
    f1 = np.zeros((1, fm + 1), dtype=np.int32)
    floor_call, _ = triplet_launcher("shared", f1, f1, *p, dev,
                                     threads=trip.default_threads(n))
    floor_call()
    floor_ms = min(cuda_ms(floor_call, 1)[0] for _ in range(3))
    del floor_call

    w = TRIPLET_WINDOW
    win = triplet_aligner(tuple(x[100:100 + w] for x in mol),
                          **TRIPLET_PARAMS)
    window = trip.oracle_layout(
        trip.fill_slabs_cuda(win.mu1, win.mu2, S, win.gamma, win.delta,
                             device=dev).cpu().numpy(), w, w, S)
    want = trip.fill_oracle(win.mu1, win.mu2, S, win.gamma, win.delta)
    j = np.arange(w + 1)
    band = np.broadcast_to(np.abs(j[None, :] - j[:, None]) <= S,
                           (w + 1, w + 1, w + 1))
    check(np.array_equal(window[band], want[band]),
          "the triplet kernel differs from fill_oracle on the window")
    b = triplet_bound(n, m, S, cells)
    big_b = triplet_bound(bn, bm, bS, big_cells)
    huge_b = triplet_bound(hn, hm, hS, huge_cells)
    D, big_D, huge_D = n + m + 1, bn + bm + 1, hn + hm + 1
    floor_us = floor_ms * 1e3 / (fm + 1)
    found = dict(
        dnapol_score=got[0], trace_columns=len(got[1]),
        outputs_equal_to_twin_on_cpu=True, first_run_s=seconds,
        optimize_s=optimize_s, optimize_stages=stages,
        kernel_ms=kernel_ms,
        kernel_ms_min_max={r: (min(v), max(v)) for r, v in kernel_ms.items()},
        us_per_diagonal={r: min(v) * 1e3 / D for r, v in kernel_ms.items()},
        staged_threads=TRIPLET_STAGED_THREADS,
        dnapol_cluster_shapes={C: trip.cluster_shape(n, S, C)
                               for C in TRIPLET_DNAPOL_CLUSTERS},
        dnapol_resident_shape=trip.resident_shape(n, S),
        wrapper_ms=wrapper_ms,
        twin_on_card_ms=plain_ms, twin_on_cpu_s=cpu_s,
        slabs_of_every_route_equal_to_twin_on_card=True, domain_cells=cells,
        bound_ms=b[0], bound_by=b[1], ns_per_load_l2=l2_ns,
        chain_floor_global_ms=D * l2_ns * 1e-6,
        one_row_us_per_diagonal=floor_us,
        chain_floor_shared_ms=D * floor_us * 1e-3,
        big=f"{bn}x{bm} max_shift {bS}", big_route=big_route,
        big_cluster_shape=trip.cluster_shape(bn, bS),
        big_cluster_shapes={C: trip.cluster_shape(bn, bS, C)
                            for C in TRIPLET_BIG_CLUSTERS},
        big_resident_shape=trip.resident_shape(bn, bS),
        big_not_resident=not_resident,
        big_score=big_got[0], big_trace_columns=len(big_got[1]),
        big_first_run_s=big_s, big_optimize_s=big_optimize_s,
        big_optimize_stages=big_stages, big_kernel_ms=big_ms,
        big_kernel_ms_min_max={r: (min(v), max(v))
                               for r, v in big_ms.items()},
        big_us_per_diagonal={r: min(v) * 1e3 / big_D
                             for r, v in big_ms.items()},
        big_ratio_to_bound={r: min(v) / big_b[0] for r, v in big_ms.items()},
        big_twin_on_card_ms=big_plain_ms, big_slabs_equal_to_twin=True,
        big_domain_cells=big_cells, big_bound_ms=big_b[0],
        big_bound_by=big_b[1],
        big_shared_bytes=trip.shared_bytes(bn, bS),
        huge=f"{hn}x{hm} max_shift {hS}", huge_route="resident",
        huge_resident_shape=trip.resident_shape(hn, hS),
        huge_score=huge_got[0], huge_trace_columns=len(huge_got[1]),
        huge_first_run_s=huge_s, huge_slab_bytes=huge_slab_bytes,
        huge_slabs_equal_to_global=True, huge_kernel_ms=huge_ms,
        huge_us_per_diagonal={r: min(v) * 1e3 / huge_D
                              for r, v in huge_ms.items()},
        huge_domain_cells=huge_cells, huge_bound_ms=huge_b[0],
        huge_bound_by=huge_b[1],
        huge_ratio_to_bound={r: min(v) / huge_b[0]
                             for r, v in huge_ms.items()},
        resident_against_cluster=route_ms,
        window=f"{w}x{w}", window_cells=int(band.sum()),
        window_equal_to_oracle=True)
    times = {"triplet_fill_shared": (min(kernel_ms["shared"]), plain_ms),
             "triplet_fill_cluster": (min(big_ms[f"cluster{big_C}"]),
                                      big_plain_ms),
             "triplet_fill_resident": (min(big_ms["resident"]),
                                       big_plain_ms),
             "triplet_fill_global": (min(big_ms["global"]), big_plain_ms)}
    bounds = {"triplet_fill_shared": b, "triplet_fill_cluster": big_b,
              "triplet_fill_resident": big_b, "triplet_fill_global": big_b}
    return found, launches, times, bounds


# -- phase 5, mesh: data parallelism and the sequence split ------------------

# K of the sequence split on the main path (DNA-Pol-1; 4000x3990 at the
# last), the Ks whose fills are timed, the K at which the split's entries
# are held to their twins at DNA-Pol-1, and the "data" meshes of the batch
# and of the stream
SPLIT_KS = (2, 4)
SPLIT_TIME_KS = (1, 2, 4)
SPLIT_TWIN_K = 2
DATA_KS = (2, 4)
STREAM_DATA_K = 2
# (n, m, max_shift) of the split's kernels against their twins on garbage
# at K = 1, 2 and 3 (a shard of one row at each end); block size
SPLIT_SHAPES = [(5, 7, 1), (17, 20, 1), (8, 8, 2), (7, 9, 0), (9, 10, 3),
                (9, 11, 4), (0, 5, 1), (6, 0, 2)]
SPLIT_BLOCK = 7


def mesh_places(k: int) -> list:
    """k shard devices: the host's cards round robin, so distinct cards
    where there are k of them, and all k on cuda:0 (a stream each) on a
    host of one card."""
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(k)]


def split_rows(n: int) -> list:
    """Row ranges of the split at K = 1, 2 (even) and 3 (one row at each
    end: shards shorter than any tile's R rows)."""
    out = [[(0, n)]]
    if n >= 1:
        out.append([(0, n // 2), (n // 2 + 1, n)])
    if n >= 2:
        out.append([(0, 0), (1, n - 1), (n, n)])
    return out


def split_forms(affine: bool, route: str = "streams") -> tuple:
    """(score fill, twin, checkpointed fill, twin, block fill, twin, the
    three counters of ``route``) of the split's entries of one kind."""
    kind = "affine" if affine else "nonaffine"
    tag = "resident_" if route == "resident" else ""
    return (ssp.seqsplit_last_slabs, ssp.seqsplit_last_slabs_plain,
            ssp.seqsplit_checkpoints, ssp.seqsplit_checkpoints_plain,
            ssp.seqsplit_block, ssp.seqsplit_block_plain,
            tuple(f"seqsplit_{tag}{what}_{kind}" for what in
                  ("score", "ckpt", "block")))


def garbage_like(shards, shape_of) -> list:
    """A tensor of garbage ``shape_of(shard)`` a shard, on its device."""
    return [garbage_band(shape_of(s), s.device) for s in shards]


# the split's routes held to the twins: (route, a CTA's rows or None)
SPLIT_ROUTES = (("streams", None), ("resident", None), ("resident", 1))


def split_against_twins(shards, S, params, affine, C, blocks,
                        routes=SPLIT_ROUTES) -> tuple:
    """The split's three entries on each of ``routes`` against their twins
    on the same garbage, the twins run once: ({(route, rows): max |err| of
    each entry}, {(route, rows): its rings}, the twin's checkpoints, ms of
    each twin's run by CUDA events, the last block's for the blocks) over
    every cell of the rings, checkpoints and the windows of ``blocks``."""
    score, score_p, ckpt, ckpt_p, block, block_p, _names = \
        split_forms(affine)
    n, m = shards[-1].b, shards[0].mu1.shape[1] - 1
    slab = lambda s: (*((9,) if affine else ()), 2 * S + 1, 2 * S + 1,
                      s.rows)
    NB = (n + m) // C + 1
    clones = lambda ts: [x.clone() for x in ts]
    errs = {r: [0, 0, 0] for r in routes}

    def against(got, want, at):
        for r in routes:
            errs[r][at] = max([errs[r][at]] + [tensor_err(a, b) for a, b
                                               in zip(got[r], want)])
    junk = garbage_like(shards, lambda s: (3, *slab(s)))
    rings = {(route, rows): score(shards, S, params, affine,
                                  rings=clones(junk), route=route, rows=rows)
             for route, rows in routes}
    ms_score, want = cuda_ms(lambda: score_p(shards, S, params, affine,
                                             rings=clones(junk)), reps=1)
    against(rings, want, 0)
    junk = garbage_like(shards, lambda s: (3, *slab(s)))
    junk_ck = garbage_like(shards, lambda s: (NB, 2, *slab(s)))
    got = {(route, rows): sum(ckpt(shards, S, params, affine, C,
                                   rings=clones(junk), ckpts=clones(junk_ck),
                                   route=route, rows=rows), [])
           for route, rows in routes}
    ms_ckpt, want = cuda_ms(lambda: ckpt_p(
        shards, S, params, affine, C, rings=clones(junk),
        ckpts=clones(junk_ck)), reps=1)
    against(got, want[0] + want[1], 1)
    ckpts = want[1]
    ms_block = None
    Cw = min(C, n + m + 1)
    for b in blocks:
        junk = garbage_like(shards, lambda s: (Cw + 2, *slab(s)))
        mine = [c[b] for c in ckpts]
        got = {(route, rows): block(shards, S, params, affine, mine, b * C,
                                    Cw, windows=clones(junk), route=route,
                                    rows=rows)
               for route, rows in routes}
        ms_block, want = cuda_ms(lambda: block_p(
            shards, S, params, affine, mine, b * C, Cw,
            windows=clones(junk)), reps=1)
        against(got, want, 2)
    return errs, rings, ckpts, (ms_score, ms_ckpt, ms_block)


def seqsplit_kernels(errs: dict) -> list:
    """Phase 3's part for the sequence split: at SPLIT_SHAPES, K = 1, 2, 3,
    each entry on each route of SPLIT_ROUTES ("resident" at its default
    rows and at a row a CTA) against its twin on garbage in every cell
    (every block), and the last slab's live row against the unsharded
    score-only kernel's."""
    ran = []
    for n, m, S in SPLIT_SHAPES:
        rng = np.random.default_rng(SEED + 7 * n + 3 * m + S)
        mu1, mu2 = rand_tables(rng, n, m)
        t1, t2 = tables_to_torch(mu1, mu2, "cuda")
        for affine in (True, False):
            params = AFFINE_PARAMS if affine else NONAFFINE_PARAMS
            whole = (cuda_dp.affine_last_slab if affine
                     else cuda_dp.nonaffine_last_slab)(t1, t2, S, *params)
            for rows in split_rows(n):
                shards = ssp.make_shards(mu1, mu2, mesh_places(len(rows)),
                                         rows=rows)
                e, rings, _ck, _ms = split_against_twins(
                    shards, S, params, affine, SPLIT_BLOCK,
                    range((n + m) // SPLIT_BLOCK + 1))
                for (route, cta_rows), err in e.items():
                    last = rings[route, cta_rows][-1][(n + m) % 3][
                        ..., n - shards[-1].a + 1]
                    e_row = tensor_err(last.to(whole.device), whole[..., n])
                    names = split_forms(affine, route)[-1]
                    for name, x in zip(names, (max(err[0], e_row), *err[1:])):
                        check(x == 0, f"{name} ({n}, {m}, {S}) rows {rows}, "
                              f"a CTA's rows {cta_rows}: max |err| {x}")
                        errs[name] = max(errs[name], x)
                ran.append((n, m, S, "affine" if affine else "nonaffine",
                            len(rows)))
    split_refusals()
    return ran


def split_refusals() -> None:
    """A forced route that cannot run raises, and nothing falls back: route
    "resident" over more shards than it takes (ValueError), and a forced
    row a CTA whose grid the card cannot hold at once (the cooperative
    launch refused, cudaErrorCooperativeLaunchTooLarge, 720), the ring
    left as it was."""
    rng = np.random.default_rng(SEED)
    mu1, mu2 = rand_tables(rng, 2 * ssp.RESIDENT_MAX_SHARDS, 5)
    many = ssp.make_shards(mu1, mu2,
                           mesh_places(ssp.RESIDENT_MAX_SHARDS + 1))
    check(ssp.split_route(many) == "streams", "route of 33 shards")
    try:
        ssp.seqsplit_last_slabs(many, 1, AFFINE_PARAMS, True,
                                route="resident")
        check(False, "route 'resident' over 33 shards did not raise")
    except ValueError:
        pass
    n = 4 * torch.cuda.get_device_properties(0).multi_processor_count * 8
    mu1, mu2 = rand_tables(rng, n, 3)
    shards = ssp.make_shards(mu1, mu2, mesh_places(1))
    junk = garbage_like(shards, lambda s: (3, 9, 3, 3, s.rows))
    ring = [x.clone() for x in junk]
    try:
        ssp.seqsplit_last_slabs(shards, 1, AFFINE_PARAMS, True, rings=ring,
                                route="resident", rows=1)
        check(False, f"a CTA a row of {n + 1} rows did not raise")
    except RuntimeError as err:
        check("error 720" in str(err), f"refused otherwise: {err}")
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(ring, junk)),
          "a refused launch wrote the ring")


def lowmem_lines(mol, params, **kw) -> tuple:
    """(score, lines, trace, seconds) of BiAligner on the DNA-Pol-1 pair."""
    seconds, score, lines, ba = run_e2e(mol, params, **kw)
    return score, lines, ba.traceback(), seconds


def split_runs(mol) -> dict:
    """The split's paths, for the launch counts: the DNA-Pol-1 pair through
    BiAligner(seqsplit_mesh=) at K = 2 and 4 on its own route and at K = 2
    forced onto route "streams" (affine max_shift 1 and the non-affine CLI
    defaults), score_seqsplit the same way, and the 4000x3990 pair's at
    K = 4.  Returns what split_checks holds to one device."""
    split, scores = {}, {}
    for name, params in (("affine", DNAPOL_FULL),
                         ("nonaffine", DNAPOL_CLI_DEFAULTS)):
        for k in SPLIT_KS:
            mesh = Mesh(mesh_places(k), ("sp",))
            split[name, k] = lowmem_lines(mol, params, seqsplit_mesh=mesh)
    ba, _t1, _t2 = port_tables(mol, DNAPOL_FULL)
    bk, _k1, _k2 = port_tables(mol, DNAPOL_CLI_DEFAULTS)
    for k in SPLIT_KS:
        mesh = Mesh(mesh_places(k), ("sp",))
        scores["affine", k] = ssp.score_seqsplit(
            ba.mu1, ba.mu2, ba.max_shift, (ba.beta, ba.gamma, ba.delta),
            mesh=mesh)
        scores["nonaffine", k] = ssp.score_seqsplit(
            bk.mu1, bk.mu2, bk.max_shift, (bk.gamma, bk.delta), mesh=mesh,
            affine=False)
    n, m, S = BIG_PAIR
    big = rand_tables(np.random.default_rng(SEED), n, m)
    big_k = max(SPLIT_KS)
    big_s, big_score = timed(lambda: ssp.score_seqsplit(
        *big, S, AFFINE_PARAMS, mesh=Mesh(mesh_places(big_k), ("sp",))))
    # the same paths forced onto route "streams" at K = 2
    mesh = Mesh(mesh_places(SPLIT_KS[0]), ("sp",))
    for name, params in (("affine", DNAPOL_FULL),
                         ("nonaffine", DNAPOL_CLI_DEFAULTS)):
        split[name, "streams"] = lowmem_lines(
            mol, params, seqsplit_mesh=mesh, seqsplit_route="streams")
    scores["affine", "streams"] = ssp.score_seqsplit(
        ba.mu1, ba.mu2, ba.max_shift, (ba.beta, ba.gamma, ba.delta),
        mesh=mesh, route="streams")
    scores["nonaffine", "streams"] = ssp.score_seqsplit(
        bk.mu1, bk.mu2, bk.max_shift, (bk.gamma, bk.delta), mesh=mesh,
        affine=False, route="streams")
    return dict(split=split, scores=scores, big=big, big_s=big_s,
                big_score=big_score, route=ssp.split_route(ssp.make_shards(
                    ba.mu1, ba.mu2, mesh_places(big_k))))


def split_checks(mol, md5, runs) -> dict:
    """split_runs' results against one device: each score, line and trace
    equal to the one-device low-memory path's (761500 and the md5 anchors),
    each score to affine_score / nonaffine_score, the 4000x3990 pair's to
    affine_score.  Returns the phase line's entries."""
    split, scores = runs["split"], runs["scores"]
    ba, t1, t2 = port_tables(mol, DNAPOL_FULL)
    bk, k1, k2 = port_tables(mol, DNAPOL_CLI_DEFAULTS)
    for name, params in (("affine", DNAPOL_FULL),
                         ("nonaffine", DNAPOL_CLI_DEFAULTS)):
        want = lowmem_lines(mol, params, lowmem=True)
        for k in (*SPLIT_KS, "streams"):
            got = split[name, k]
            check(got[:3] == want[:3], f"split {name} K={k}: score, lines "
                  "or trace differ from the one-device low-memory path")
        split[name] = dict(score=want[0], lowmem_s=want[3],
                           split_s={k: split[name, k][3] for k in SPLIT_KS},
                           streams_k2_s=split[name, "streams"][3])
    check(split["affine"]["score"] == 761500, "split DNA-Pol-1 score")
    for k in (*SPLIT_KS, "streams"):
        check(md5_anchors(split["affine", k][1]) == md5,
              f"split DNA-Pol-1 md5 anchors, K={k}")
    want_a = cuda_dp.affine_score(t1, t2, ba.max_shift, ba.beta, ba.gamma,
                                  ba.delta)
    want_n = cuda_dp.nonaffine_score(k1, k2, bk.max_shift, bk.gamma, bk.delta)
    for k in (*SPLIT_KS, "streams"):
        check(scores["affine", k] == want_a == 761500,
              f"score_seqsplit K={k}: {scores['affine', k]}")
        check(scores["nonaffine", k] == want_n,
              f"score_seqsplit non-affine K={k}: {scores['nonaffine', k]}")
    n, m, S = BIG_PAIR
    big_one = cuda_dp.affine_score(*tables_to_torch(*runs["big"], "cuda"), S,
                                   *AFFINE_PARAMS)
    check(runs["big_score"] == big_one,
          f"{n}x{m} split {runs['big_score']} != {big_one}")
    return dict(
        split_dnapol=dict(affine=split["affine"], nonaffine=split["nonaffine"],
                          md5_anchors="all 6 equal", ks=SPLIT_KS,
                          route=runs["route"]),
        score_seqsplit=dict(affine=want_a, nonaffine=want_n, ks=SPLIT_KS),
        big_pair=dict(n=n, m=m, k=max(SPLIT_KS), score=runs["big_score"],
                      split_s=runs["big_s"]))


def phase_mesh(mol, md5) -> tuple[dict, dict]:
    """The mesh phase (launches counted apart, the counts read before the
    one-device references run): the sequence split of the DNA-Pol-1 pair
    through BiAligner(seqsplit_mesh=) at K = 2 and 4 (761500 and the md5
    anchors, and the non-affine CLI defaults), score_seqsplit there and on
    the 4000x3990 pair at K = 4; the realistic batch's scores and
    alignments from tables and from codes over "data" meshes of 2 and 4;
    the stream's scores and alignments from codes over a mesh of 2.  Then
    each against one device, pair by pair."""
    found = dict(device_count=torch.cuda.device_count(),
                 layouts={k: mesh_places(k) for k in
                          sorted({*SPLIT_KS, *DATA_KS, STREAM_DATA_K})})
    t_phase = time.perf_counter()
    reset_counts()
    runs = split_runs(mol)
    windows = realistic_windows(mol, SEED)
    tables = [host_tables(w, DNAPOL_FULL)[:2] for w in windows]
    costs = (DNAPOL_FULL["gap_opening_cost"], DNAPOL_FULL["gap_cost"],
             DNAPOL_FULL["shift_cost"])
    lut = torch.from_numpy(np.ascontiguousarray(
        _sim_lut("BLOSUM62")[0], np.int32)).to("cuda")
    codes = [pbatch.encode_pair(w["seqA"], w["seqB"], w["strA"], w["strB"])
             for w in windows]
    kw = dict(affine=True, bucket_quantum=REALISTIC_QUANTUM)
    ckw = dict(kw, lut=lut, structure_weight=DNAPOL_FULL["structure_weight"])

    def batch_runs(mesh):
        return dict(
            score_tables=timed(lambda: pbatch.score_batch(
                tables, 1, costs, mesh=mesh, **kw)),
            align_tables=timed(lambda: pbatch.align_batch(
                tables, 1, costs, mesh=mesh, **kw)),
            score_codes=timed(lambda: pbatch.dispatch_score_batch_codes(
                codes, 1, costs, mesh=mesh, **ckw).get()),
            align_codes=timed(lambda: pbatch.dispatch_align_batch_codes(
                codes, 1, costs, mesh=mesh, **ckw).get()))
    batches = {k: batch_runs(Mesh(mesh_places(k), ("data",)))
               for k in DATA_KS}
    corpus = stream_corpus(mol)
    where = ROOT / "build" / "mesh"
    where.mkdir(parents=True, exist_ok=True)

    def stream(mesh, alignments, tag):
        spool = where / f"{tag}.jsonl"
        if spool.exists():
            spool.unlink()
        sa = StreamingAligner(DNAPOL_FULL, mesh=mesh, spool_path=str(spool),
                              chunk_pairs=STREAM_CHUNK,
                              bucket_quantum=STREAM_QUANTUM,
                              alignments=alignments, codes=True)
        seconds, out = timed(lambda: list(sa.run(corpus)))
        sa.spool.close()
        return seconds, out, read_spool(spool)
    data_mesh = Mesh(mesh_places(STREAM_DATA_K), ("data",))
    streams = {a: stream(data_mesh, a, f"mesh_{a}") for a in (False, True)}
    launches = {**path_counts("seqsplit"), **path_counts("mesh")}

    # the references on one device, after the counts are read
    found.update(split_checks(mol, md5, runs))

    one = batch_runs(None)
    rates = {"one_device": {}}
    for what, (seconds, want) in one.items():
        rates["one_device"][what] = len(windows) / seconds
        for k in DATA_KS:
            got = batches[k][what][1]
            if what.startswith("score"):
                check((got == want).all(), f"mesh {k} {what} differs")
            else:
                check((got[0] == want[0]).all() and got[1] == want[1]
                      and got[2] == want[2], f"mesh {k} {what} differs")
            rates.setdefault(f"mesh_{k}", {})[what] = (
                len(windows) / batches[k][what][0])
    for a in (False, True):
        seconds, out, spooled = streams[a]
        s1, o1, sp1 = stream(None, a, f"one_{a}")
        check(out == o1 and spooled == sp1,
              f"stream (alignments={a}) over a mesh differs from one device")
        rate = "alignments_per_s" if a else "pairs_per_s"
        found[f"stream_codes_{'alignments' if a else 'scores'}"] = {
            rate: {f"mesh_{STREAM_DATA_K}": len(out) / seconds,
                   "one_device": len(o1) / s1}, "records": len(out)}
    found.update(batch_rates_pairs_per_s=rates,
                 phase_s=time.perf_counter() - t_phase)
    return found, launches


def split_fill(mol, route: str = "streams"):
    """The DNA-Pol-1 split's score-only fill at K = 4 on ``route``, run
    once: a function that runs it again."""
    seqA, strA, seqB, strB = mol
    ba = BiAligner(seqA, seqB, strA, strB, **DNAPOL_FULL)
    p = (ba.beta, ba.gamma, ba.delta)
    shards = ssp.make_shards(ba.mu1, ba.mu2, mesh_places(4))
    fill = lambda: ssp.seqsplit_last_slabs(  # noqa: E731
        shards, 1, p, True, route=route)
    fill()
    return fill


def profiled_split(fill, out: Path, route: str = "streams") -> dict:
    """The split's fill of :func:`split_fill` on ``route`` under
    torch.profiler: device busy and idle time; on route "streams" the halo
    copies' share of the busy time (some 7,500 device events); on route
    "resident" its kernels, which must be one a card (the one launch of
    the call)."""
    out.mkdir(parents=True, exist_ok=True)
    summary, dev = traced(fill, out / f"trace_split_k4_{route}.json")
    found = dict(window_us=summary["window_us"],
                 device_busy_us=summary["device_busy_us"],
                 device_idle_share=summary["device_idle_share"])
    if route == "resident":
        spans, dur, _gaps = dp_kernel_stats(dev, ("resident_split",))
        cards = len(set(mesh_places(4)))
        check(len(spans) == cards and not dp_kernel_stats(dev, ("_diag",))[0],
              f"{len(spans)} split kernels traced, {cards} cards: "
              f"{sorted(summary['kernels'])}")
        return dict(found, split_kernels=len(spans), kernel_us=dur.tolist(),
                    other_device_events={
                        k: v["count"] for k, v in summary["kernels"].items()
                        if "resident_split" not in k})
    copies = sum(k["total_us"] for name, k in summary["kernels"].items()
                 if "Memcpy" in name)
    kernels = sum(k["total_us"] for name, k in summary["kernels"].items()
                  if "Memcpy" not in name and "Memset" not in name)
    return dict(found, halo_copies_us=copies, kernels_us=kernels,
                halo_share_of_busy=copies / summary["device_busy_us"])


def halo_bytes(shards, m: int, cells: int, first: int, last: int) -> int:
    """Bytes the halo copies move over diagonals first..last: ``cells``
    values read and written a copy, one a shard boundary a diagonal on
    which the boundary's row lies."""
    copies = sum(max(0, min(last, s.b + m) - max(first, s.b) + 1)
                 for s in shards[:-1])
    return copies * cells * 4 * 2


def split_turns(fills: dict, reps: int = 3) -> dict:
    """name -> ms of each of ``fills`` (CUDA events, ``reps`` runs a turn),
    warm, in turns: every fill once in order, then in reverse."""
    turns = {name: [] for name in fills}
    for fn in fills.values():
        fn()                                                  # warm-up
    for name in list(fills) + list(fills)[::-1]:
        turns[name].append(cuda_ms(fills[name], reps=reps)[0])
    return turns


def route_fills(shards, S, p, C, tag: str) -> dict:
    """The affine split's fills on ``shards`` on both routes, named
    ``<route>_<tag>_<form>``: score-only, checkpointed, the middle block,
    and every block of the band one after another (a traceback's
    refills)."""
    score, _sp, ckpt, _cp, block, _bp, _names = split_forms(True)
    n, m = shards[-1].b, shards[0].mu1.shape[1] - 1
    NB, Cw = (n + m) // C + 1, min(C, n + m + 1)
    _rings, ckpts = ckpt(shards, S, p, True, C)
    fills = {}
    for route in ssp.ROUTES:
        def blocks(route=route):
            for b in range(NB):
                block(shards, S, p, True, [c[b] for c in ckpts], b * C, Cw,
                      route=route)
        fills[f"{route}_{tag}_score"] = \
            lambda route=route: score(shards, S, p, True, route=route)
        fills[f"{route}_{tag}_ckpt"] = \
            lambda route=route: ckpt(shards, S, p, True, C, route=route)
        fills[f"{route}_{tag}_block"] = lambda route=route: block(
            shards, S, p, True, [c[NB // 2] for c in ckpts], NB // 2 * C,
            Cw, route=route)
        fills[f"{route}_{tag}_blocks_all"] = blocks
    return fills


def phase_mesh_timing(mol, errs: dict) -> tuple[dict, dict, dict]:
    """The split's twelve entries at DNA-Pol-1 on SPLIT_TWIN_K shards
    against their twins on the same garbage (the score-only fill, the
    checkpointed fill, the middle block; both routes against one run of
    the twins), each timed beside its twin; then both routes' fills in
    turns at K = 1, 2, 4 (score-only, checkpointed, the middle block and
    all the band's blocks) beside the one-device score-only and
    checkpointed fills, and at 4000x3990, K = 4, the score-only fill.
    Returns (times, bounds, more)."""
    seqA, strA, seqB, strB = mol
    times, bounds, more = {}, {}, {}
    routes = (("streams", None), ("resident", None))
    for affine, params in ((True, DNAPOL_FULL), (False, DNAPOL_CLI_DEFAULTS)):
        ba = BiAligner(seqA, seqB, strA, strB, **params)
        S, n, m = ba.max_shift, len(seqA), len(seqB)
        p = (ba.beta, ba.gamma, ba.delta) if affine else (ba.gamma, ba.delta)
        cases, states = (15, 9) if affine else (13, 1)
        cells = states * (2 * S + 1) ** 2
        score, _sp, ckpt, _cp, block, _bp, _names = split_forms(affine)
        shards = ssp.make_shards(ba.mu1, ba.mu2, mesh_places(SPLIT_TWIN_K))
        C = ckp.default_block(n + m + 1)
        NB = (n + m) // C + 1
        mid = NB // 2
        t0 = time.perf_counter()
        e, _rings, ckpts, twin_ms = split_against_twins(shards, S, p, affine,
                                                        C, [mid], routes)
        twin_check_s = time.perf_counter() - t0
        mine = [c[mid] for c in ckpts]
        Cw = min(C, n + m + 1)
        whole = dp_bound(n, m, S, cases, states, band=False)
        slab = cells * (n + 1) * 4
        halo = halo_bytes(shards, m, cells, 0, n + m)
        d = np.arange(mid * C, min((mid + 1) * C, n + m + 1))
        live = int((np.minimum(n, d) - np.maximum(0, d - m) + 1).sum())
        form_bounds = (
            bound(2 * (n + 1) * (m + 1) * 4 + slab + halo,
                  (n + 1) * (m + 1) * (2 * S + 1) ** 2 * states * cases * 2),
            bound(2 * (n + 1) * (m + 1) * 4 + slab + (NB - 1) * 2 * slab
                  + halo,
                  (n + 1) * (m + 1) * (2 * S + 1) ** 2 * states * cases * 2),
            bound(2 * slab + 2 * live * 4 + (len(d) + 2) * slab
                  + halo_bytes(shards, m, cells, int(d[0]), int(d[-1])),
                  live * (2 * S + 1) ** 2 * states * cases * 2))
        for route, rows in routes:
            names = split_forms(affine, route)[-1]
            for name, err in zip(names, e[route, rows]):
                check(err == 0, f"{name} DNA-Pol-1 K={SPLIT_TWIN_K}: max "
                      f"|err| {err}")
                errs[name] = max(errs[name], err)
            runs = {names[0]: lambda: score(shards, S, p, affine,
                                            route=route),
                    names[1]: lambda: ckpt(shards, S, p, affine, C,
                                           route=route),
                    names[2]: lambda: block(shards, S, p, affine, mine,
                                            mid * C, Cw, route=route)}
            for (name, kernel), ms_p, b in zip(runs.items(), twin_ms,
                                               form_bounds):
                kernel()                                      # warm-up
                times[name] = (cuda_ms(kernel, reps=5)[0], ms_p)
                bounds[name] = b
            launches = (SPLIT_TWIN_K * (n + m + 1) if route == "streams"
                        else len(set(mesh_places(SPLIT_TWIN_K))))
            more[names[0]] = dict(k=SPLIT_TWIN_K, launches_a_call=launches,
                                  us_per_diagonal=times[names[0]][0] * 1e3
                                  / (n + m + 1), halo_bytes=halo,
                                  one_device_bound_ms=whole[0],
                                  twin_check_s=twin_check_s)
            more[names[1]] = dict(k=SPLIT_TWIN_K, block=C, blocks=NB)
            more[names[2]] = dict(k=SPLIT_TWIN_K, one_block=mid, diagonals=Cw)
        if not affine:
            continue
        # both routes at K = 1, 2, 4 beside one device's fills, in turns
        t1, t2 = tables_to_torch(ba.mu1, ba.mu2, "cuda")
        fills = {"one_device_score": lambda: cuda_dp.affine_last_slab(
                     t1, t2, S, *p),
                 "one_device_ckpt": lambda: ckp.fill_affine_checkpoint(
                     t1, t2, S, *p)}
        for k in SPLIT_TIME_KS:
            fills.update(route_fills(
                ssp.make_shards(ba.mu1, ba.mu2, mesh_places(k)), S, p, C,
                f"k{k}"))
        more["split_ms_in_turns"] = split_turns(fills)
        # the 4000x3990 pair at K = 4: the score-only fill
        bn, bm, bS = BIG_PAIR
        big = rand_tables(np.random.default_rng(SEED), bn, bm)
        big_shards = ssp.make_shards(*big, mesh_places(max(SPLIT_KS)))
        b1, b2 = tables_to_torch(*big, "cuda")
        more["big_pair_ms_in_turns"] = split_turns({
            "one_device_score": lambda: cuda_dp.affine_last_slab(
                b1, b2, bS, *AFFINE_PARAMS),
            **{f"{route}_k4_score": lambda route=route: score(
                big_shards, bS, AFFINE_PARAMS, True, route=route)
               for route in ssp.ROUTES}}, reps=2)
        more["big_pair_ms_in_turns"]["n_m_k"] = [bn, bm, max(SPLIT_KS)]
    return times, bounds, more


def say_split_times(smi: str, errs: dict) -> None:
    """phase_mesh_timing's line, alone (--mesh-only, --split-only)."""
    times, bounds, more = phase_mesh_timing(dnapol_pair(), errs)
    say("5 kernel times, sequence split", nvidia_smi=smi,
        ms_kernel_vs_plain={
            k: {"kernel_ms": v[0], "plain_ms": v[1],
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
            for k, v in times.items()}, details=more, max_abs_err=errs)


# The fuzz phase (also alone: --fuzz-only): every kernel of KERNELS held to
# its plain twin on the card, on garbage memory, over the seeded cases of
# tests/torch_fuzz_cases.py, the generator the CPU tests draw from: n and m
# up to FUZZ_MAX_LEN, max_shift up to each family's limit (17 affine, 48
# non-affine, the triplet across its route boundary at 8), random costs in
# [-500, 200] and the corner sets, random, tie-heavy and int32-edge tables.
# Rounds of one case a family, until FUZZ_SECONDS are spent; round 0 always
# whole, with the cases at the limits, K3 across its 1024-row boundary, the
# DNA-Pol-1 pair at max_shift 3, 5 and 8 through BiAligner, and tables
# beyond the int32 certificate (the int64 engine, no kernel).
FUZZ_SECONDS = 240       # about phase 3's own time, beside which it runs
FUZZ_MAX_LEN = 300
FUZZ_CELLS = 2_000_000          # 4-D cells (x 9 states affine) a case
FUZZ_SPLIT_KS = (1, 2, 3)
FUZZ_DNAPOL_SHIFTS = (3, 5, 8)
# DNA-Pol-1 at DNAPOL_FULL's costs and max_shift 3: the JAX package's XLA
# engine and the port's plain twin agree
DNAPOL_MS3_SCORE = 771550


@functools.lru_cache(maxsize=1)
def fuzz_generator():
    """tests/torch_fuzz_cases.py, read from the checkout (numpy only)."""
    spec = importlib.util.spec_from_file_location(
        "torch_fuzz_cases", ROOT / "tests" / "torch_fuzz_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FuzzTally:
    """Per kernel of KERNELS: its calls held to the twin, and max |err|."""

    def __init__(self):
        self.cases = dict.fromkeys(KERNELS, 0)
        self.err = dict.fromkeys(KERNELS, 0)

    def add(self, name: str, e: int, what: str) -> None:
        check(e == 0, f"fuzz {name} [{what}]: max |err| {e}")
        self.cases[name] += 1
        self.err[name] = max(self.err[name], e)

    def line(self) -> dict:
        return {k: {"cases": self.cases[k], "max_abs_err": self.err[k]}
                for k in KERNELS}


def fuzz_pair(case, affine: bool, dev, tally: FuzzTally, rng) -> None:
    """One pair through every single-pair kernel of its kind: the band fill
    on a band of garbage, its walk, the score-only fill on a ring of
    garbage, the checkpointed fill, every block and block walk, and the
    split on uneven shards over both routes."""
    n, m, S = case.n, case.m, case.max_shift
    params, what = case.params(affine), case.tag()
    mu1, mu2 = case.tables()
    t1, t2 = tables_to_torch(mu1, mu2, dev)
    kind = "affine" if affine else "nonaffine"
    W = 2 * S + 1
    cells = ((9,) if affine else ()) + (W, W)
    fill, fill_plain = ((cuda_dp.fill_affine_device, cuda_dp.fill_affine_plain)
                        if affine else (cuda_dp.fill_nonaffine_device,
                                        cuda_dp.fill_nonaffine_plain))
    bp = fill_plain(t1, t2, S, *params)
    junk = garbage_band(tuple(bp.ys.shape), dev)
    bk = fill(t1, t2, S, *params, band=junk.clone())
    live = live_rows(n, m, bp.ys.dim(), dev)
    tally.add(f"fill_{kind}", tensor_err(bk.ys, torch.where(live, bp.ys,
                                                            junk)), what)
    check(bk.final_score() == bp.final_score(), f"fuzz score [{what}]")
    if affine:
        walked = dtb.affine_traceback(bk, *params, t1, t2)
        tp, cp = dtb.affine_traceback_plain(bp, *params, t1, t2)
        e = max(trace_err(walked[0], tp), int(walked[1] != cp))
    else:
        walked = dtb.nonaffine_traceback(bk, *params, t1, t2)
        e = trace_err(walked, dtb.nonaffine_traceback_plain(bp, *params, t1,
                                                            t2))
    tally.add(f"walk_{kind}", e, what)

    last = (cuda_dp.affine_last_slab if affine else
            cuda_dp.nonaffine_last_slab)(
        t1, t2, S, *params, ring=garbage_ring(rng, (3, *cells, n + 1), dev))
    tally.add(f"score_{kind}", row_err(last, bp.ys[n + m], n), what)

    (ck_fill, ck_plain, block, block_plain, bwalk, bwalk_plain, traceback,
     _costs, (ck_name, block_name, walk_name)) = lowmem_forms(affine)
    D = n + m + 1
    C = ckp.default_block(D)
    if case.seed % 2:                 # another block size around it
        C = int(rng.integers(max(C // 2, 1), 2 * C + 5))
    NB = (n + m) // C + 1
    ring = garbage_band((3, *cells, n + 1), dev)
    ckpts = garbage_band((NB, 2, *cells, n + 1), dev)
    cb = ck_fill(t1, t2, S, *params, block=C, ring=ring.clone(),
                 ckpts=ckpts.clone())
    twin = ck_plain(t1, t2, S, *params, block=C, ring=ring, ckpts=ckpts)
    tally.add(ck_name, max(tensor_err(cb.ckpts, twin.ckpts),
                           tensor_err(cb.final, twin.final)), what)
    walk_k, walk_p = ckp.new_walk(cb), ckp.new_walk(cb, "cpu")
    twinned = {0, NB // 2, NB - 1}
    for b in range(NB - 1, -1, -1):
        junk = garbage_band(cb.window_shape, dev)
        window = block(cb, b, window=junk.clone())
        e = tensor_err(window, window_from_band(cb, b, bp, junk))
        if b in twinned:
            e = max(e, tensor_err(window, block_plain(cb, b, window=junk)))
        tally.add(block_name, e, f"{what} C={C} block {b}")
        bwalk(cb, b, window, walk_k)
        bwalk_plain(cb, b, window, walk_p)
        tally.add(walk_name, tensor_err(walk_k.cpu(), walk_p),
                  f"{what} C={C} block {b}")
    check(traceback(cb, *params) == walked,
          f"fuzz blockwise traceback [{what}] C={C}")

    K = int(rng.choice([k for k in FUZZ_SPLIT_KS if k <= n + 1]))
    rows = fuzz_generator().uneven_rows(rng, n, K)
    shards = ssp.make_shards(mu1, mu2, mesh_places(K), rows=rows)
    routes = SPLIT_ROUTES if n + 1 <= 64 else SPLIT_ROUTES[:2]
    errs, rings, _ck, _ms = split_against_twins(
        shards, S, params, affine, C, sorted({0, NB - 1}), routes=routes)
    for (route, cta_rows), err in errs.items():
        tail = rings[route, cta_rows][-1][(n + m) % 3][
            ..., n - shards[-1].a + 1]
        e_row = tensor_err(tail.to(dev), bp.ys[n + m][..., n])
        for name, x in zip(split_forms(affine, route)[-1],
                           (max(err[0], e_row), *err[1:])):
            tally.add(name, x, f"{what} rows {rows} a CTA's {cta_rows}")


def fuzz_ms0(n: int, m: int, costs, tables, dev, tally: FuzzTally, rng,
             what: str) -> None:
    """K3 on its own route and every forced one, from one ring of garbage:
    each ring equal to the twin's in every cell."""
    t1, t2 = tables_to_torch(*tables, dev)
    junk = garbage_ring(rng, (3, 3, n + 1), dev)
    twin = junk.clone()
    cuda_dp.affine_ms0_last_slab_plain(t1, t2, *costs, ring=twin)
    own = cuda_dp.batch_route(n, 0, True, B=1)
    names = {"cta": "score_affine_ms0", "grid": "score_affine_ms0_grid",
             "resident": "score_affine_ms0_resident"}
    forms = [(None, {}), ("resident", {}), ("grid", {})]
    if cuda_dp.cta_fits(n, 0, True):
        forms.append(("cta", {}))
    if -(-(n + 1) // 3) <= 4 * 32:
        forms.append(("resident", dict(ctas=3, threads=32)))
    for route, kw in forms:
        ring = junk.clone()
        cuda_dp.affine_ms0_last_slab(t1, t2, *costs, ring=ring, route=route,
                                     **kw)
        tally.add(names[route or own], tensor_err(ring, twin),
                  f"{what} route {route or own} {kw}")


def fuzz_bucket(case, affine: bool, dev, tally: FuzzTally, rng) -> None:
    """A bucket of mixed lengths (the case's n and m its size) through K4/K5
    ("grid"), K8 on one and three lanes, K6/K7 ("cta") where a pair fits
    one CTA, all on rings of garbage, then K4/K5 in band mode on a band of
    garbage and the batch walks."""
    N, M, S = max(case.n, 1), max(case.m, 1), case.max_shift
    params, what = case.params(affine), case.tag()
    F = fuzz_generator()
    B = int(rng.integers(2, 9))
    lengths = F.mixed_bucket(rng, N, M, B)
    tables = [F.draw_tables(rng, n, m, case.table_kind, case.costs)
              for n, m in lengths]
    stacks = tuple(torch.from_numpy(a).to(dev) for a in (
        pbatch.stack_padded([t[0] for t in tables], N, M),
        pbatch.stack_padded([t[1] for t in tables], N, M),
        np.asarray([n for n, _m in lengths], np.int32),
        np.asarray([m for _n, m in lengths], np.int32)))
    W = 2 * S + 1
    kind = "affine" if affine else "nonaffine"
    cells = ((9,) if affine else ()) + (W, W)
    (kern, plain, conveyor_plain) = (
        (cuda_dp.affine_batch_scores, cuda_dp.affine_batch_scores_plain,
         cuda_dp.affine_conveyor_scores_plain) if affine else
        (cuda_dp.nonaffine_batch_scores, cuda_dp.nonaffine_batch_scores_plain,
         cuda_dp.nonaffine_conveyor_scores_plain))
    want = plain(*stacks, S, *params)
    got = kern(*stacks, S, *params, route="grid",
               ring=garbage_ring(rng, (B, 3, *cells, N + 1), dev))
    tally.add(f"batch_{kind}", score_err(got, want), what)
    for lanes in sorted({1, min(3, B)}):
        belt = kern(*stacks, S, *params, route="conveyor", lanes=lanes,
                    ring=garbage_ring(rng, (lanes, 3, *cells, N + 1), dev))
        e = score_err(belt, want)
        if conveyor_steps(B, M, lanes, N + M) <= CONVEYOR_TWIN_STEPS:
            e = max(e, score_err(belt, conveyor_plain(*stacks, S, *params,
                                                      lanes=lanes)))
        tally.add("conveyor_scores", e, f"{what} lanes {lanes}")
    if cuda_dp.cta_fits(N, S, affine):
        ms0 = affine and S == 0
        if ms0:
            def ring_twin(mu1, mu2, ring):
                cuda_dp.affine_ms0_last_slab_plain(mu1, mu2, *params,
                                                   ring=ring)
        else:
            last_plain = (cuda_dp.affine_last_slab_plain if affine
                          else cuda_dp.nonaffine_last_slab_plain)

            def ring_twin(mu1, mu2, ring):
                last_plain(mu1, mu2, S, *params, ring=ring)
        junk = garbage_ring(rng, (B, 3, *((3,) if ms0 else cells), N + 1),
                            dev)
        rings_want = cta_rings_want(stacks, junk, ring_twin)
        for threads in (None, 64):
            ring = junk.clone()
            cta = kern(*stacks, S, *params, route="cta", ring=ring,
                       threads=threads)
            tally.add("cta_scores_ms0" if ms0 else "cta_scores",
                      max(score_err(cta, want), tensor_err(ring, rings_want)),
                      f"{what} threads {threads}")

    fill, fill_plain, walk, walk_plain = (
        (cuda_dp.affine_batch_bands, cuda_dp.affine_batch_bands_plain,
         dtb.affine_walk_batch, dtb.affine_walk_batch_plain) if affine else
        (cuda_dp.nonaffine_batch_bands, cuda_dp.nonaffine_batch_bands_plain,
         dtb.nonaffine_walk_batch, dtb.nonaffine_walk_batch_plain))
    d_max = max(n + m for n, m in lengths)
    junk = garbage_band((B, d_max + 1, *cells, N + 1), dev)
    bk, sk = fill(*stacks, S, *params, d_max=d_max, band=junk.clone())
    bp, sp = fill_plain(*stacks, S, *params, d_max=d_max, band=junk)
    tally.add(f"batch_fill_{kind}", max(batch_band_err(bk, bp),
                                        score_err(sk, sp),
                                        score_err(sk, want)), what)
    e, _steps = walks_err(walk(bk, *params, *stacks[:2]),
                          walk_plain(bp, *params, *stacks[:2]))
    tally.add(f"walk_{kind}_batch", e, what)


def fuzz_triplet(case, dev, tally: FuzzTally, rng) -> None:
    """The triplet fill on every route that can hold the pair, each on
    slabs of garbage: the twin's values on the domain, the garbage kept
    elsewhere; a forced "shared" beyond it must raise."""
    n, m, S = case.n, case.m, case.max_shift
    gamma, delta = case.params(False)
    mu1, mu2 = case.tables()
    want = trip.fill_slabs(mu1, mu2, S, gamma, delta, device=dev)
    forms = [dict(route="global"), dict(route="resident"),
             dict(route="resident", ctas=3)]
    if trip.triplet_route(n, S) == "shared":
        forms.append(dict(route="shared"))
    else:
        try:
            trip.fill_slabs_cuda(mu1, mu2, S, gamma, delta, device=dev,
                                 route="shared")
            check(False, f"fuzz triplet [{case.tag()}]: a forced 'shared' "
                  "that does not fit ran")
        except ValueError:
            pass
    if trip.cluster_shape(n, S) is not None:
        forms.append(dict(route="cluster"))
    if trip.cluster_shape(n, S, 3) is not None:
        forms.append(dict(route="cluster", cluster=3))
    for kw in forms:
        junk = garbage_band(tuple(want.shape), dev)
        got = trip.fill_slabs_cuda(mu1, mu2, S, gamma, delta, device=dev,
                                   ys=junk.clone(), **kw)
        tally.add(f"triplet_fill_{kw['route']}",
                  triplet_err(got, want, junk, n, m, S),
                  f"{case.tag()} {kw}")


def fuzz_dnapol(mol, dev, shifts) -> dict:
    """The DNA-Pol-1 pair through BiAligner on the card at ``shifts``
    against the twin's score on the card; at max_shift 3 also the golden.
    Returns each max_shift's score and the seconds of both runs."""
    out = {}
    for S in shifts:
        params = dict(DNAPOL_FULL, max_shift=S)
        seconds, score, _lines, ba = run_e2e(mol, params)
        t1, t2 = tables_to_torch(ba.mu1, ba.mu2, dev)
        t = time.perf_counter()
        twin = cuda_dp.affine_score_plain(t1, t2, S, ba.beta, ba.gamma,
                                          ba.delta)
        check(score == twin, f"fuzz DNA-Pol-1 max_shift {S}: {score} "
              f"against the twin's {twin}")
        if S == 3:
            check(score == DNAPOL_MS3_SCORE, f"DNA-Pol-1 max_shift 3 golden: "
                  f"{score} != {DNAPOL_MS3_SCORE}")
        out[f"max_shift_{S}"] = dict(score=score, aligner_s=seconds,
                                     twin_s=time.perf_counter() - t)
        del ba, t1, t2
    return out


def fuzz_int64(dev, rng) -> int:
    """Tables beyond the int32 certificate through BiAligner on the card:
    a RuntimeWarning, the int64 engine's score, and no kernel launched."""
    import warnings
    ba = BiAligner(**TOY, type="Protein", simmatrix="BLOSUM62",
                   gap_opening_cost=-150, gap_cost=-50, shift_cost=-150,
                   max_shift=1)
    n, m = ba.mu1.shape[0] - 1, ba.mu1.shape[1] - 1
    ba.mu1, ba.mu2 = fuzz_generator().int32_outside_tables(rng, n, m)
    before = counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        score = ba.optimize()
        ba.traceback()
    check(any("int64" in str(w.message) for w in caught),
          "tables beyond the int32 certificate: no int64 warning")
    check(counts() == before, "tables beyond the int32 certificate "
          "reached a kernel")
    want = cuda_dp.fill_affine_plain(
        *(torch.from_numpy(mu.astype(np.int64)) for mu in (ba.mu1, ba.mu2)),
        1, ba.beta, ba.gamma, ba.delta, dtype=torch.int64).final_score()
    check(score == want, f"int64 engine {score} != {want}")
    return score


def phase_fuzz(dev, seconds: float) -> tuple[dict, dict]:
    """The fuzz phase; returns (the fuzz line's dict, a summary with each
    kind's seconds and the slowest cases)."""
    F, tally = fuzz_generator(), FuzzTally()
    rng = np.random.default_rng(SEED + 17)
    t0 = time.perf_counter()
    rows = {True: lambda S: cuda_dp.tile_rows(S, True),
            False: lambda S: cuda_dp.tile_rows(S, False)}
    ran, by_kind = [], {}

    def run(kind: str, tag: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t
        ran.append((round(dt, 2), kind, tag))
        by_kind[kind] = by_kind.get(kind, 0.0) + dt
        return out

    def pair(case):
        run("pair", case.tag(), fuzz_pair, case, case.family == "affine",
            dev, tally, rng)

    def bucket(case):
        run("bucket", case.tag(), fuzz_bucket, case, case.family == "affine",
            dev, tally, rng)

    def triplet(case):
        run("triplet", case.tag(), fuzz_triplet, case, dev, tally, rng)

    def ms0(case, n, m, tables):
        run("ms0", f"{case.tag()} at n={n} m={m}", fuzz_ms0, n, m,
            case.costs, tables, dev, tally, rng, case.tag())

    # round 0's own cases: each family at its limit on a toy shape, the
    # triplet on both sides of its boundary, K7, K3 across its 1024 rows
    for case in (F.at_limit("affine", 0), F.at_limit("nonaffine", 1),
                 F.at_limit("affine", 2, max_len=12, max_shift=5),
                 F.at_limit("nonaffine", 3, max_len=12, max_shift=16)):
        pair(case)
    for case in (F.at_limit("triplet", 0, max_len=40),
                 F.at_limit("triplet", 1, max_len=120,
                            max_shift=F.TRIPLET_STATIC_SHIFTS),
                 F.at_limit("triplet", 2, max_len=120,
                            max_shift=F.TRIPLET_STATIC_SHIFTS + 1)):
        triplet(case)
    bucket(F.at_limit("affine", 4, max_len=40, max_shift=0))
    for k, n in enumerate(range(F.MS0_RESIDENT_ROWS - 2,
                                F.MS0_RESIDENT_ROWS + 1)):
        case = F.draw("ms0", 100 + k, max_len=FUZZ_MAX_LEN)
        m = max(case.m, 1)
        ms0(case, n, m, F.draw_tables(rng, n, m, case.table_kind,
                                      case.costs))
    dnapol = run("dnapol", "DNA-Pol-1", fuzz_dnapol, dnapol_pair(), dev,
                 FUZZ_DNAPOL_SHIFTS)
    int64_score = run("int64", "toy protein", fuzz_int64, dev, rng)
    rounds = 0
    while rounds == 0 or time.perf_counter() - t0 < seconds:
        r = rounds
        max_len = FUZZ_MAX_LEN if r % 2 == 0 else 40
        # round 0 at max_shift <= 4 (its own cases reach the limits), then
        # up to the limits one round in three
        def wide(family: str, k: int) -> int:
            return F.LIMITS[family] if r and r % 3 == k else 4
        for family in ("affine", "nonaffine"):
            pair(F.draw(family, r, max_len=max_len,
                        max_shift=wide(family, 1), cells=FUZZ_CELLS,
                        rows=rows[family == "affine"]))
            bucket(F.draw(family, 1000 + r, max_len=max_len // 2,
                          max_shift=wide(family, 2), cells=FUZZ_CELLS // 16,
                          rows=rows[family == "affine"]))
        case = F.draw("ms0", r, max_len=max_len)
        ms0(case, case.n, case.m, case.tables())
        triplet(F.draw("triplet", r, max_len=max_len,
                       max_shift=wide("triplet", 0),
                       cells=FUZZ_CELLS))
        rounds += 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()        # its largest bands, for later phases
    missing = [k for k, v in tally.cases.items() if v == 0]
    check(not missing, f"fuzz: kernels without a case: {missing}")
    return tally.line(), dict(
        rounds=rounds, cases=len(ran), seconds=time.perf_counter() - t0,
        seconds_by_kind=by_kind, slowest=sorted(ran, reverse=True)[:10],
        dnapol=dnapol, int64_score=int64_score)


EXAMPLE_PAIRS = 32          # one chunk of examples/batch_streaming_torch.py
EXAMPLE_SPOOL = ROOT / "build" / "examples" / "scores.jsonl"


def start_examples() -> dict:
    """The port's three examples (examples/*_torch.py, their defaults: the
    CUDA kernels), each started in a process of its own: the README
    walkthrough, the DNA-Pol-1 pipeline (no plot: the card's machine has
    no matplotlib) and a stream of EXAMPLE_PAIRS pairs."""
    EXAMPLE_SPOOL.parent.mkdir(parents=True, exist_ok=True)
    EXAMPLE_SPOOL.unlink(missing_ok=True)
    runs = {"readme_walkthrough_torch.py": (),
            "dnapol_pipeline_torch.py": (),
            "batch_streaming_torch.py": (str(EXAMPLE_PAIRS), "--spool",
                                         str(EXAMPLE_SPOOL))}
    return {script: (time.perf_counter(), subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for script, args in runs.items()}


def phase_examples(dev, started: dict) -> dict:
    """The examples of :func:`start_examples`, waited for and checked: the
    README walkthrough's SCORE 6800 and 48500 (each asserted by the example)
    and its lines equal to the goldens'; the DNA-Pol-1 pipeline's 761500;
    the stream's spool equal to the plain twins' stream over the same pairs
    on the card."""
    found, out = {}, {}
    for script, (t0, proc) in started.items():
        stdout, stderr = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"{script}: {stderr[-2000:]}")
        found[script] = {"seconds": time.perf_counter() - t0}
        out[script] = stdout.splitlines()

    G = load_golden()
    lines = out["readme_walkthrough_torch.py"]
    gap = lines.index("")
    check(lines[0] == "SCORE: 6800" and lines[gap + 1] == "SCORE: 48500",
          f"readme walkthrough scores {lines[0]!r} {lines[gap + 1]!r}")
    check(lines[1:gap] == list(G.TOY_RNA_AFFINE_DEFAULT_OUT)
          and lines[gap + 2:] == list(G.TOY_PROTEIN_SORTED_OUT),
          "readme walkthrough: its lines differ from the goldens")
    lines = out["dnapol_pipeline_torch.py"]
    check(lines[0].startswith("SCORE: 761500 "), lines[0])
    found["dnapol_pipeline_torch.py"]["first_line"] = lines[0]
    found["batch_streaming_torch.py"]["devices"] = \
        out["batch_streaming_torch.py"][0]
    spec = importlib.util.spec_from_file_location(
        "batch_streaming_torch", ROOT / "examples" / "batch_streaming_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    twin = StreamingAligner(example.PARAMS, chunk_pairs=32, engine="torch",
                            device=dev)
    want = dict(twin.run(example.records(EXAMPLE_PAIRS)))
    got = {r["id"]: r["score"] for r in read_spool(EXAMPLE_SPOOL)}
    check(got == want, "batch streaming example: its spool differs from the "
          "plain twins' stream")
    found["batch_streaming_torch.py"]["pairs"] = len(got)
    return found


FUZZ_LOG = ROOT / "build" / "fuzz"


def start_fuzz() -> subprocess.Popen:
    """The fuzz phase in a process of its own (--fuzz-only), beside phase 3:
    both hold kernels to twins, whose launches leave the card mostly idle,
    and the process's launches are not this one's counts.  Its output goes
    to files (a pipe nobody reads until phase 3 ends would stop it)."""
    FUZZ_LOG.mkdir(parents=True, exist_ok=True)
    with open(FUZZ_LOG / "stdout.txt", "w") as out, \
            open(FUZZ_LOG / "stderr.txt", "w") as err:
        return subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--fuzz-only",
             "--fuzz-seconds", str(FUZZ_SECONDS)], cwd=ROOT, stdout=out,
            stderr=err, text=True)


def fuzz_of(proc) -> tuple[dict, dict]:
    """The fuzz line's dict and the summary of the process of
    :func:`start_fuzz`, once it has ended; fails where it failed."""
    proc.wait(timeout=1200)
    stderr = (FUZZ_LOG / "stderr.txt").read_text()
    check(proc.returncode == 0, f"the fuzz phase: exit {proc.returncode}: "
          f"{stderr[-3000:]}")
    lines = (FUZZ_LOG / "stdout.txt").read_text().splitlines()
    summary = next(ln for ln in lines if ln.startswith("[3 fuzz] "))
    return (json.loads(lines[-1])["fuzz"],
            json.loads(summary[len("[3 fuzz] "):]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kernels-only", action="store_true",
        help="stop after phase 3: build the kernels, print what ptxas says "
        "and hold each against its plain twin at small shapes (a new "
        "kernel's first run on a card)")
    parser.add_argument(
        "--tile-times", action="store_true",
        help="build, then only time the tile kernels K1, K2, K4, K5, K8 and "
        "K9-K12 (no twins); run from an older checkout it times that "
        "checkout's kernels")
    parser.add_argument(
        "--walk-times", action="store_true",
        help="build, then only time the walk kernels (single-pair, batch, "
        "block; no twins) and, where the checkout has it, the chain probe; "
        "run from an older checkout it times that checkout's walks")
    parser.add_argument(
        "--stream-only", action="store_true",
        help="build, then only the stream phase: the streaming driver, its "
        "batch CLI and the warmup, each checked")
    parser.add_argument(
        "--triplet-only", action="store_true",
        help="build, then only the triplet aligner: its kernel against the "
        "twin (phase 3's cases), the DNA-Pol-1 pair through "
        "BiAlignerTriplet against the twin on the CPU, the kernel's times")
    parser.add_argument(
        "--resident-only", action="store_true",
        help="build, then only the two fills of route 'resident': K3's "
        "phase 3 checks and times beyond one CTA, and the triplet's phase 3 "
        "checks and phase 5 (every route, the pair beyond any portable "
        "cluster, 'resident' against 'cluster' in turns)")
    parser.add_argument(
        "--profile-stress", action="store_true",
        help="build, then only the stress phase, with the in-process "
        "traces after the large one that reproduce the conditions of a "
        "trace-count check that once fell short")
    parser.add_argument(
        "--profile-one", metavar="NAME",
        help="(run by this script) make a context on the card, print "
        "'ready', wait for a line on standard input, then make phase 7's "
        "measurement NAME and print its result as the last line")
    parser.add_argument(
        "--mesh-only", action="store_true",
        help="build, then only the sequence split's kernels against their "
        "twins and the mesh phase (the split and the data-parallel paths, "
        "their kernel times)")
    parser.add_argument(
        "--split-only", action="store_true",
        help="build, then only the sequence split: its kernels on both "
        "routes against their twins, its paths at DNA-Pol-1 and 4000x3990 "
        "against one device, both routes' times (on a host of several "
        "cards the shards lie on distinct cards, through peer memory)")
    parser.add_argument(
        "--fuzz-only", action="store_true",
        help="build, then only the fuzz phase: every kernel against its "
        "twin on the seeded cases of tests/torch_fuzz_cases.py, and its "
        "fuzz line")
    parser.add_argument(
        "--fuzz-seconds", type=float, default=FUZZ_SECONDS,
        help="seconds after which the fuzz phase starts no new round "
        f"(default {FUZZ_SECONDS}; round 0 always runs whole)")
    parser.add_argument(
        "--pair-tables-only", action="store_true",
        help="build, then only the protein pair's tables built on the card "
        "from codes: against the host tables, the goldens through them, "
        "both routes' times in turns")
    parser.add_argument(
        "--fills-only", action="store_true",
        help="build, then only time the single-pair fills, score-only fills "
        "and walks at the DNA-Pol-1 shapes against their twins (phase 5's "
        "kernel times; two checkouts compared in one call)")
    args = parser.parse_args()
    if args.profile_one:
        # the measurement's set-up and the profiler's session, while the
        # other measurements' processes do the same
        check(torch.cuda.is_available(), "no CUDA device")
        _build.load()                       # built by the calling process
        measure = profile_setup(args.profile_one, ROOT / "build" / "profile")
        PREPARED.append(prepared_profiler())
        print("ready", flush=True)
        sys.stdin.readline()                # this process's turn
        print(json.dumps(measure()))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    say("1 device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(dev),
        count=torch.cuda.device_count())

    t0 = time.perf_counter()
    # a library newer than every source is this checkout's (the fuzz
    # phase's process, started by the whole script once it has built)
    report = _build.build() if _build.stale() else ""
    _build.load()
    resources = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
    say("2 build", seconds=time.perf_counter() - t0,
        library=str(_build.LIB_PATH), ptxas=resources)

    if args.tile_times:
        say("5 tile kernel times", nvidia_smi=smi, root=str(ROOT),
            ms=tile_times(dnapol_pair()))
        return 0
    if args.walk_times:
        say("5 walk times", nvidia_smi=smi, root=str(ROOT),
            **walk_times(dnapol_pair()))
        return 0
    if args.stream_only:
        stream, stream_launches = phase_stream(dnapol_pair(), dnapol_md5(),
                                               smi)
        say("5 stream", nvidia_smi=smi, launches=stream_launches, **stream)
        for name in PATHS["stream"]:
            check(stream_launches[name] > 0,
                  f"kernel {name} not launched by the stream")
        say("5 stream, double buffer", nvidia_smi=smi,
            **stream_double_buffer(dnapol_pair()))
        say("7 profile, stream", nvidia_smi=smi, alignments_codes=(
            profiled_in_children(["stream_alignments_codes"])[
                "stream_alignments_codes"]))
        return 0
    if args.profile_stress:
        say("8 stress", nvidia_smi=smi, **phase_profile_stress(
            dnapol_pair(), ROOT / "build" / "profile" / "stress",
            in_process=True))
        return 0
    if args.fuzz_only:
        fuzz, summary = phase_fuzz(dev, args.fuzz_seconds)
        say("3 fuzz", nvidia_smi=smi, **summary)
        print(json.dumps({"fuzz": fuzz}))
        return 0
    errs = dict.fromkeys(KERNELS, 0)
    if args.resident_only:
        phase_k3_kernels(dev, errs)
        k3_times, k3_bounds, k3_more = k3_beyond_times(errs)
        say("5 kernel times, K3 beyond one CTA", nvidia_smi=smi,
            ms_kernel_vs_plain={k: {"kernel_ms": v[0], "plain_ms": v[1],
                                    "bound_ms": k3_bounds[k][0],
                                    "bound_by": k3_bounds[k][1]}
                                for k, v in k3_times.items()},
            details=k3_more, cta_against_resident=k3_route_times(),
            max_abs_err={k: errs[k] for k in errs if "ms0" in k})
    if args.triplet_only or args.resident_only:
        ran = phase_triplet_kernels(dev, errs)
        say("3 kernels, triplet", triplet_n_m_shift_tables_routes=ran,
            triplet_threads=TRIPLET_THREADS,
            max_abs_err={k: errs[k] for k in PATHS["triplet"]})
        triplet, triplet_launches, times, bounds = phase_triplet(
            dnapol_pair(), dev, errs)
        say("5 triplet", nvidia_smi=smi, launches=triplet_launches, **triplet)
        say("5 kernel times, triplet", nvidia_smi=smi, ms_kernel_vs_plain={
            k: {"kernel_ms": v[0], "plain_ms": v[1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1]} for k, v in times.items()})
        for name in PATHS["triplet"]:
            check(triplet_launches[name] > 0,
                  f"kernel {name} not launched by the triplet path")
        return 0
    if args.mesh_only:
        say("3 kernels, sequence split", max_abs_err=errs,
            seqsplit_n_m_shift_kind_shards=seqsplit_kernels(errs))
        mesh, mesh_launches = phase_mesh(dnapol_pair(), dnapol_md5())
        say("5 mesh", nvidia_smi=smi, launches=mesh_launches, **mesh)
        for name in PATHS["seqsplit"] + PATHS["mesh"]:
            check(mesh_launches[name] > 0,
                  f"kernel {name} not launched by the mesh phase")
        say_split_times(smi, errs)
        found = profiled_in_children(["split_k4", "split_k4_resident"])
        say("7 profile, split", nvidia_smi=smi,
            score_fill_k4_streams=found["split_k4"],
            score_fill_k4_resident=found["split_k4_resident"])
        return 0
    if args.split_only:
        say("3 kernels, sequence split", max_abs_err=errs,
            seqsplit_n_m_shift_kind_shards=seqsplit_kernels(errs))
        reset_counts()
        runs = split_runs(dnapol_pair())
        launches = path_counts("seqsplit")
        say("5 split", nvidia_smi=smi, device_count=torch.cuda.device_count(),
            layouts={k: mesh_places(k) for k in SPLIT_TIME_KS},
            launches=launches,
            **split_checks(dnapol_pair(), dnapol_md5(), runs))
        for name in PATHS["seqsplit"]:
            check(launches[name] > 0, f"kernel {name} not launched")
        say_split_times(smi, errs)
        return 0
    if args.pair_tables_only:
        say("5 pair tables", nvidia_smi=smi, **phase_pair_tables(
            dnapol_pair(), dnapol_md5(), load_golden()))
        return 0
    if args.fills_only:
        times, bounds, more = phase_full_timing(dnapol_pair(), errs)
        k3_times, k3_bounds, more["k3_beyond_one_cta"] = k3_beyond_times(
            errs)
        times.update(k3_times)
        bounds.update(k3_bounds)
        say("5 kernel times", nvidia_smi=smi, ms_kernel_vs_plain={
            k: {"kernel_ms": v[0], "plain_ms": v[1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1]} for k, v in times.items()},
            details=more, max_abs_err=errs)
        return 0
    if args.kernels_only:
        phase_kernels(dev, errs)
        say("stopped after phase 3 (--kernels-only)")
        return 0
    # the fuzz phase and the examples in processes of their own, while
    # phase 3 runs: all are checks, none is timed against the others
    fuzz_proc, examples = start_fuzz(), start_examples()
    phase_kernels(dev, errs)
    fuzz, summary = fuzz_of(fuzz_proc)
    say("3 fuzz", **summary)
    say("5 examples", nvidia_smi=smi, **phase_examples(dev, examples))

    G = load_golden()
    mol = dnapol_pair()
    md5 = dnapol_md5()
    # each path's launches are counted apart: counts to 0, the path, read
    reset_counts()
    phase_goldens(G)
    full = phase_full_main(mol, md5)
    launches = path_counts("band")
    say("5 full size", **full)
    say("5 pair tables", nvidia_smi=smi, **phase_pair_tables(mol, md5, G))
    reset_counts()
    full_score = phase_full_score(mol)
    launches.update(path_counts("score_only"))
    say("5 full size, score only", nvidia_smi=smi, **full_score)
    reset_counts()
    full_batch, batches = phase_batch_main(mol)
    launches.update(path_counts("batch"))
    say("5 full size, batched scores", nvidia_smi=smi, **full_batch)

    reset_counts()
    full_align = phase_align_main(mol, batches, md5, G)
    launches.update(path_counts("align"))
    say("5 full size, batched alignments and codes", nvidia_smi=smi,
        **full_align)

    reset_counts()
    full_lowmem = phase_lowmem_main(mol, md5, G, dev)
    launches.update(path_counts("lowmem"))
    say("5 full size, low memory", nvidia_smi=smi, **full_lowmem)

    # phase_mesh sets the counts to 0 before its paths and reads them after
    # them, before its one-device references run
    mesh, mesh_launches = phase_mesh(mol, md5)
    launches.update({k: v for k, v in mesh_launches.items()
                     if k.startswith("seqsplit_")})
    say("5 mesh", nvidia_smi=smi, launches=mesh_launches, **mesh)

    # phase_triplet sets the counts to 0 before its path and reads them
    # after it, before the twins and the timing run
    triplet, triplet_launches, triplet_times, triplet_bounds = phase_triplet(
        mol, dev, errs)
    launches.update(triplet_launches)
    say("5 triplet", nvidia_smi=smi, launches=triplet_launches, **triplet)

    times, bounds, more = phase_full_timing(mol, errs)
    times.update(triplet_times)
    bounds.update(triplet_bounds)
    k3_times, k3_bounds, more["k3_beyond_one_cta"] = k3_beyond_times(errs)
    more["k3_cta_against_resident"] = k3_route_times()
    times.update(k3_times)
    bounds.update(k3_bounds)
    batch_times, batch_bounds, batch_more = phase_batch_timing(batches, errs)
    more.update(batch_more)
    times.update(batch_times)
    bounds.update(batch_bounds)
    align_times, align_bounds, align_more = phase_align_timing(batches, errs)
    times.update(align_times)
    bounds.update(align_bounds)
    more.update(align_more)
    lowmem_times, lowmem_bounds, lowmem_more = phase_lowmem_timing(mol, errs)
    times.update(lowmem_times)
    bounds.update(lowmem_bounds)
    more.update(lowmem_more)
    mesh_times, mesh_bounds, mesh_more = phase_mesh_timing(mol, errs)
    times.update(mesh_times)
    bounds.update(mesh_bounds)
    more.update(mesh_more)
    say("5 kernel times", nvidia_smi=smi,
        ms_kernel_vs_plain={k: {"kernel_ms": v[0], "plain_ms": v[1],
                                "bound_ms": bounds[k][0],
                                "bound_by": bounds[k][1]}
                            for k, v in times.items()},
        details=more)
    say("5 big pair", nvidia_smi=smi, **phase_big_pair(dev))
    say("5 chain latency", nvidia_smi=smi, **chain_latency(dev))

    say("6 launches", **launches)
    for name in KERNELS:
        check(launches[name] > 0, f"kernel {name} not launched by the path")
    say("6 launches, mesh", **mesh_launches)
    for name in PATHS["seqsplit"] + PATHS["mesh"]:
        check(mesh_launches[name] > 0,
              f"kernel {name} not launched by the mesh phase")
    out = ROOT / "build" / "profile"
    report = phase_profile(out)
    split_k4 = report.pop("split_k4")
    split_k4_resident = report.pop("split_k4_resident")
    stream_profile = report.pop("stream_alignments_codes")
    say("7 profile", out=str(out), **{
        name: {key: ({k: v for k, v in val.items() if k != "kernels"}
                     if isinstance(val, dict) else val)
               for key, val in r.items()}
        for name, r in report.items()})
    say("7 profile, split", nvidia_smi=smi, score_fill_k4_streams=split_k4,
        score_fill_k4_resident=split_k4_resident)
    say("7 profile, stream", nvidia_smi=smi, alignments_codes=stream_profile)

    # phase_stream sets the counts to 0 before its StreamingAligner runs
    # and reads them after them, before its checks launch the batch path
    stream, stream_launches = phase_stream(mol, md5, smi)
    say("5 stream", nvidia_smi=smi, launches=stream_launches, **stream)
    say("6 launches, stream", **stream_launches)
    for name in PATHS["stream"]:
        check(stream_launches[name] > 0,
              f"kernel {name} not launched by the stream")
    say("8 stress", nvidia_smi=smi, **phase_profile_stress(
        mol, out / "stress", in_process=False))

    print(json.dumps({"fuzz": fuzz}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call computes a banded max-plus recurrence
         # over four indices (or the triplet's three), for one pair or a
         # bucket, or walks one
         "library_ms": None}
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        # a launch of a route "resident" that trapped names its CTA here
        # (cuda_dp.fault_word)
        fault = getattr(cuda_dp, "_FAULT", None)
        if fault and int(fault[0][0]):
            print(f"route 'resident' fault word {fault[0].tolist()}",
                  file=sys.stderr)
        raise
