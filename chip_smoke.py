#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and nvcc:

* ``build``: compiles every CUDA kernel of ``machisplin_tpu_torch/csrc`` with
  nvcc (one process per source) and loads it with ctypes;
* ``kernel_k1``: runs the TPS grid kernel on a full-resolution tile of the
  main path's tiling (real knots from a spline fit on ``sampling.csv``
  packed to their knot budget, of which the tables keep the live ones; two
  responses) and holds it against its plain PyTorch version to
  2e-4 * max|surface|, with CUDA-event times for both and the kernel's bound;
* ``mltps_gm``: the main path, ``mltps(load_sampling(),
  synthetic_covariates(downsample=1), tps=True,
  config=MLTPSConfig(letters_pool="gm"))`` on the full 2476 x 3264 grid with
  the covariates as built (float32) and numpy-drawn folds, counting the
  kernel's launches and holding every r^2 to the JAX package's float32 value
  for the same run (``tools/record_jax_gm_r2.py 1``) within 0.02;
* ``mltps_gm_f64``: the same run with the covariates cast to float64, held
  to the JAX package's float64 values (``tools/record_jax_gm_r2.py
  --float64 1``) within 2e-3, with the same kept letters;
* ``kernel_k2``: the tree grower K2 against its plain version on the
  stations' covariates binned globally, at the CV shape (200 chains, tree
  complexity 25) and the finals' shape (20 chains, tree complexity 5,
  emitting trees), at a first tree and after 300 boosting steps: every
  chain's tree the same, or parting at a near-tie (relative gain gap <=
  1e-5), and f within 1e-5 of the residuals' scale where the trees agree;
  then a 50-tree cycle in one launch bit-identical to 50 one-tree launches,
  and CUDA-event times per tree through the cycle entry; then four checks
  beyond the batched BRT's shapes, each a 50-tree cycle against the plain
  version with ms a tree, its bound and ptxas's registers and spills: bin
  tables per chain (10 CV folds, each binned on its own training rows,
  tree complexity 5), gbm's monotone check (the finals' shape with signs;
  all-zero signs bit-identical to none), the rows in device memory forced
  at the CV shape (bit-identical to shared memory), and station counts
  whose rows do not fit shared memory (K2_CEILING: 200 chains x 8,000
  seeded stations x p = 5 x tree complexity 25, 20 x 40,000 x 5);
* ``mltps_b``: the slice's path, ``mltps(..., config=MLTPSConfig(
  letters_pool="b"))`` on the full grid (covariates as built, float32),
  counting every kernel's launches (K1 = 6, K2 and K3 > 0, K2 in 50-tree
  cycles, with its launches and trees for the CV and the finals), both responses
  keeping "b", every r^2 within 0.01 of the JAX package's value for key 0
  (``tools/record_jax_b_r2.py``);
* ``kernel_k3``: the forest predictor K3 against its plain version on one
  full-width 256-row panel of the grid, with the forest ``mltps_b`` built
  (every tree in the outcome-table loop) and with K2-grown trees of 6 and 9
  splits (the 9-split trees in the slot loop of the same launch):
  leaf-membership counts equal, weighted sums within 1e-5 of sum |w v|; the
  bound from the path compares and adds these cells need, which must not
  exceed the kernel's time; the 6-split trees timed tabled and slot-tested
  (the measurement behind ``ops/forest.S_MAX``).
* ``nn_lbfgs``: the NN letter's L-BFGS (``optim/lbfgs.py``, the port's
  copy of optax's ``lbfgs(memory_size=20)`` and zoom line search) at the CV
  shape (20 lanes x 813 stations, p = 5, h = 10): float64 steps from the
  same seeded inits on the card and on the CPU, predictions within
  NN_TOL_EARLY of the response range after 10 steps and NN_TOL after 50;
  then 200 float32 steps timed (ms a step and a pass, passes and
  line-search evaluations a step, host syncs a step, kernel launches a
  step and a pass from ``torch.profiler``, eager and through the CUDA
  graph);
* ``mltps_bn``: the pool the reference keeps, ``mltps(...,
  config=MLTPSConfig(letters_pool="bn"))`` on the full grid (float32):
  K1 = 6, K2 and K3 > 0 launches, finite surfaces, the kept letters as the
  JAX package's wherever all its recorded keys agree, each r² within
  max(0.01, 3 x the JAX package's spread over keys) of their mean
  (``tools/record_jax_bn_r2.py``), the CV's seconds per letter, the NN
  finals and raster pass, and peak device memory;
* ``kernel_svm``: the SVM's coordinate sweep K4 against its plain version
  at SVM_SHAPES: the CV shape (20 (response x fold) lanes x 813 stations,
  120 sweeps) and the finals' (2 lanes x 813 x 120) in float32 (theta and
  the multiplier within SVM_TOL["float32"] of C) and float64
  (SVM_TOL["float64"]), and 20 lanes x 4096 seeded stations x 4 sweeps in
  float32; per shape the first launch's and the warm CUDA-event ms, ns a
  coordinate step, the bound from bytes and operations and the plain
  version's ms; ptxas's registers and spills, and the chain loop's
  instructions a step from the SASS (``tools/sass_loop.py k4``);
* ``mltps_main``: the north-star call, ``mltps(load_sampling(),
  synthetic_covariates(downsample=1), tps=True)`` with no ``letters_pool``
  (the six-letter pool "bgnmrv"), float32 as built, numpy-drawn folds:
  K1 = 6, K2, K3 and K4 > 0 launches, finite surfaces, the kept letters
  those of the JAX package's recorded keys (one of theirs where the keys
  disagree), each r² within max(0.01, 3 x the keys' spread) of their mean
  (``tools/record_jax_main_r2.py``), per-phase seconds with every CV
  letter apart, and peak device memory.  ``kernel_k3`` also holds K3 on a
  merged 2-response random forest of the default 500 trees a response
  grown on the stations (every tree in the slot loop);
* ``cv_b_8000``: ``run_cv(algorithms="b")`` on CV_B_STATIONS seeded
  stations (beyond a block's shared memory), ``max_trees`` cut to
  CV_B_MAX_TREES (printed): finite residuals for every station, K2
  launched;
* ``mltps_one``: the single-response north-star call, bio_1 alone with the
  default pool at full size (float32, folds from numpy_folds(813, 10, 1,
  seed=0)): a kept BRT's final through the serial gbm.step on K2 (its K2
  launches counted), K1 = 6, K3 and K4 > 0 launches, finite surfaces, the
  kept letters of the JAX keys, each r² within max(0.01, 3 x the keys'
  spread) of their mean (``tools/record_jax_one_r2.py``);
* ``tiles_main``: README Example 2 on the full grid, ``tiles_create(
  synthetic_covariates(downsample=1), load_sampling(), **TILES)`` (2 x 2
  tiles, the layout held to the JAX package's), the north-star call on
  every tile (folds from numpy_folds(n_t, 10, 2, seed=t)), the three
  writers, every ``<layer>.tif`` read back onto the card bit for bit, and
  ``tiles_merge`` of the read-back finals on the card against the same
  merge on the CPU (MERGE_TOL of max |surface|, the full grid, finite over
  the covariates): per tile K1, K2 and K4 > 0 launches (K3 where a tile
  keeps "b"), K2 in 50-tree cycles, each r² within max(0.01, 3 x the JAX
  keys' spread) of their mean (``tools/record_jax_tiles_r2.py``), the
  kept letters where every key agrees;
* ``resume_tile``: the first tile's bio_1 result saved with ``save_layer``,
  then ``mltps_resumable`` over bio_1 and bio_12 with a ``log_file``: bio_1
  loaded with no kernel launch and bit for bit, bio_12 computed on the
  card (a kept BRT's final through the serial gbm.step), the log non-empty;
* ``cv_b_perfold``: the batched gbm.step's bins at the CV shape (813
  stations x 2 responses, ``CVConfig.brt``): ``fit_outer_batched`` with the
  global table, 20 shared tables and 200 per-fold tables (launches, trees,
  best trees per response, seconds), ``fit_multi`` with both bins at the
  finals' shape, and a 50-tree cycle of each layout timed, the shared and
  per-fold ones held against K2's plain version (TIE_GAP).

* ``tps_config4``: BASELINE config 4, the north star's 100,000 stations
  over a 10,000 x 10,000 grid (``benchmarks/run_configs.py``'s draws):
  ``tps_fit_auto`` routes to the Nystrom fit with 4,096 landmarks (first
  call and warm, and the fit's steps), fitted r² against the noise-free
  signal; the fit at the recorder's numpy landmarks held to the JAX
  package's (``tools/record_jax_nystrom.py``: lambda, GCV, effective df,
  2,000 stations' fitted values, 4,096 cells of the surface); the 10^8
  cells in 1,536-row panels on K1 with a device-side checksum and one
  synchronise; K1 against its plain version on one panel;
* ``tps_config3``: BASELINE config 3, 10,000 stations x 19 responses:
  Nystrom with 2,048 landmarks (held to the JAX package's lambdas and
  fitted values), the first 8,192 stations through the exact device fit,
  3,000 through the host float64 fit (held to the card's exact float64
  fit and to the JAX package's host fit), ``torch.linalg.eigh`` of a
  symmetric 8,192-row matrix timed in float32 and float64 with its
  workspace (the exact path's knot limit), the 19 surfaces over 3,163 x
  3,163 cells on K1 (3 launches), K1 against its plain version at R = 19;
* ``tps_config5``: BASELINE config 5, 500,000 stations, 4,096 landmarks,
  the 31,623 x 31,623 surface streamed in 2,048-row bands, K1 against its
  plain version on one band, fitted r² against the signal;
* ``mltps_ext_f64``: ``mltps`` on the full grid in float64 with the smooth
  GAM, MARS at degree 2, the sweep weight search and the tile loop, held
  to the JAX package's run (``tools/record_jax_ext_r2.py``);
* ``rf_finals_unmerged``: the RF pool at downsample 4 with
  ``batch_final_rf`` False and True from one seed: the same surfaces, K3
  launches of each.

The device mesh (``parallel/sharded.py``), each phase's ranks started with
``torch.multiprocessing.spawn`` and a ``file://`` store after the build,
every collective with MESH_TIMEOUT_S; a rank that fails fails the phase:

* ``mesh_main``: ``mltps_main``'s call (the same folds and generator seed)
  under ``MLTPSConfig(mesh=make_mesh())`` over 2 gloo ranks on the one
  card: the CV residuals of b, v and r bit for bit (K2's chains, K4's lanes
  and the RF's forests split), g, m and n within MESH_GM_TOL and NN_TOL of
  their range; the same kept letters,
  r² within MESH_R2_TOL, final rasters within MESH_RASTER_TOL of max
  |surface|, every rank's LayerResults identical; each rank's K1-K4
  launches and phase seconds.  Where the machine has 2 or more cards the
  same call also runs on NCCL over min(count, 4) of them; on one card a
  line says it did not run;
* ``mesh_nccl1``: world size 1 on NCCL: config 4's float64 Nystrom fit
  through ``nystrom_tps_fit(mesh=)`` and ``batched_tile_tps`` over the
  north-star grid's six TPS tiles (K1 six launches), each against its
  unsharded call;
* ``mesh_config4_2r``: config 4's Nystrom fit over 2 gloo ranks in float64
  and float32, against the unsharded fit (lambda on the same grid point).

``tiles_main`` also reads one GeoTIFF through the host library's decoder
(``io/native.py``, built with g++ by ``build``) and holds it bit for bit
against the pure-Python codec; a line says so if g++ finds no zlib.h.

Each phase prints one JSON line; then the kernel table, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero; so does a run without a CUDA device, or outside a checkout.
"""
from __future__ import annotations

import importlib
import json
import logging
import os
import subprocess
import sys
import time

log = logging.getLogger("chip_smoke")

# The JAX package's values for these runs (folds from numpy_folds(813, 10, 2,
# seed=0)), from CPU runs of
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_gm_r2.py [--float64] 1`.
JAX_REFERENCE = {
    "float64": {
        "bio_1": {"kept": "gm", "r2_ensemble": 0.8147260152130515, "r2_final": 0.9967941103902852},
        "bio_12": {"kept": "m", "r2_ensemble": 0.7416836371554276, "r2_final": 0.9068688548689734},
    },
    "float32": {
        "bio_1": {"kept": "gm", "r2_ensemble": 0.8151210302054405, "r2_final": 0.9979223054672883},
        "bio_12": {"kept": "m", "r2_ensemble": 0.7352740566202252, "r2_final": 0.9094304814818496},
    },
}
# float64 runs agree to round-off.  In float32 the JAX package's own r² moves
# by up to 0.0174 with the BLAS summation order alone (bio_12 r² ensemble at
# downsample 4, multi- vs single-threaded), and the kept letters sit near the
# 5 % weight cut, so float32 runs are held to a band, not to the letters.
R2_TOL = {"float64": 2e-3, "float32": 2e-2}
K1_TOL = 2e-4

# The JAX package's values for mltps over the BRT pool (covariates as built,
# float32; folds from numpy_folds(813, 10, 2, seed=0); PRNG key 0), from
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_b_r2.py --keys 0,1,2,3 1`.
JAX_REFERENCE_B = {
    "bio_1": {"kept": "b", "r2_ensemble": 0.9279753557146534, "r2_final": 0.9950903953662055},
    "bio_12": {"kept": "b", "r2_ensemble": 0.8545358083105786, "r2_final": 0.9324266439853093},
}
# The port's bags come from torch, the JAX package's from threefry; over keys
# 0-3 the JAX package's own r² spans up to R2_SPREAD_B (bio_12 r² ensemble).
R2_SPREAD_B = 0.0035
R2_TOL_B = 0.01
# K2 against its plain version: trees that part must part at a near-tie
TIE_GAP = 1e-5
K2_TOL = 1e-5   # of max |y - f|, where the trees agree
K2_CYCLE = 50   # trees per K2 launch on the BRT path: gbm.step's step_size
# the deviance sums where a cycle's trees agree: float32 sums of 813 rows in
# another order (n eps ~ 5e-5), and f within K2_TOL
K2_DEV_RTOL = 1e-4
K3_TOL = 1e-5   # of sum |w v| per response
# K2 at station counts whose rows do not fit a block's shared memory (the
# parent's ceiling was ~6,050 stations at p = 5): (chains, seeded stations,
# tree complexity)
K2_CEILING = {"ceiling_8000": (200, 8000, 25), "ceiling_40000": (20, 40000, 5)}
# The near-tie gap at those shapes.  TIE_GAP (1e-5) is below float32's
# resolution there: at 200 chains x 8,000 stations x tc 25, 50 trees, the
# plain version parts from itself with its rows permuted (the same function,
# float32 sums in another order) in 34 chains, 12 of them at gaps above 1e-5,
# up to 7.06e-5 (CPU run, PR 11), and K2 from the plain version in 36 chains,
# 13 above 1e-5, up to 1.55e-4 (NVIDIA H100 80GB HBM3, 700.00 W, PR 11): a
# deep node's gain is a small difference of large terms, so the sums' float32
# noise reaches it amplified.  The checks there also print the plain
# version's parting from itself and hold K2's parted chains to at most twice
# its count plus 5.
CEILING_TIE_GAP = 1e-3
# CV letter b on seeded stations beyond that ceiling; max_trees cut from
# 10,000 to keep the phase to seconds
CV_B_STATIONS, CV_B_MAX_TREES = 8000, 1000

# README Example 2 (tiles_create -> mltps per tile -> tiles_merge) on the full
# grid: 2 x 2 tiles (the reference's default is 3 x 3, V73:1165; 2 x 2 is
# examples/tiled_landscape.py's), overlap feather_d / 2 cells a side
TILES = {"out_ncol": 2, "out_nrow": 2, "feather_d": 50}
# The JAX package's tiles_create on the same inputs (synthetic_covariates(1),
# load_sampling()): each tile's extent and station count, from
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_tiles_r2.py 1` (its
# first line).
JAX_TILES_LAYOUT = {
    "extents": [[-77.7644099259, -76.3627433153, -7.893583365299999, -6.8202500749],
                [-76.4044099803, -75.00274336969999, -7.893583365299999, -6.8202500749],
                [-77.7644099259, -76.3627433153, -6.861916739899999, -5.7885834495],
                [-76.4044099803, -75.00274336969999, -6.861916739899999, -5.7885834495]],
    "stations": [209, 195, 216, 222], "shapes": [[1263, 1657]] * 4,
}
# The JAX package's per-tile values (the default pool on each tile; covariates
# as built, float32; folds from numpy_folds(n_t, 10, 2, seed=t)), PRNG keys
# 0-7, from `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_tiles_r2.py
# --keys 0,1,2,3,4,5,6,7 1` (CPU, 2,868-3,119 s a key).  Held as the
# north-star call's values are: each r² within max(R2_TOL_B, 3 x the keys'
# spread) of their mean, the kept letters only where every key agrees.  On a
# tile of ~200 stations the keys part widely, and eight keys are recorded,
# not four: tile 3's bio_1 keeps "bnv" with r² final 0.991-0.994 in keys 0-6
# but "bn" in key 7, whose r² final falls with the SVM's share under the 5 %
# cut; tile 4's bio_1 r² final runs from 0.985 to -2.41 (the TPS correction,
# not kept there, degrades the ensemble).
JAX_REFERENCE_TILES = [
    {
        "bio_1": {"kept": ["bnmv", "bnmv", "bnmr", "bnmv", "bmv", "bnmv", "bnmr", "bnmv"],
                  "r2_ensemble": [0.9527660140976526, 0.9595669881872116, 0.9638144179931092, 0.9702990074317281, 0.9528169095660658, 0.9524428432824876, 0.9640333354854411, 0.9616735143346529],
                  "r2_final": [0.98826202109964, 0.9856222780015584, 0.9645224232745634, 0.9713788773595969, 0.9352084962170799, 0.9889466773415388, 0.9785234332363744, 0.9674968637656677]},
        "bio_12": {"kept": ["bnm", "bmv", "bnm", "bnmr", "bnmv", "bnm", "bnm", "bm"],
                  "r2_ensemble": [0.8271580615622558, 0.7993956787313481, 0.8265112125795929, 0.815233116197005, 0.8078291655445229, 0.8374796918368839, 0.8225052357124074, 0.8091177264550136],
                  "r2_final": [0.8447164271601855, 0.8096165855102453, 0.8061416569877015, 0.8382728497134408, 0.8261210061907358, 0.855487618910442, 0.8416519332440443, 0.802653432988536]},
    },
    {
        "bio_1": {"kept": ["bv", "bv", "bnv", "bnv", "bv", "bnv", "bnv", "bnv"],
                  "r2_ensemble": [0.8540628286262649, 0.8550982983109793, 0.8602703366335213, 0.8630204479813632, 0.84574482123071, 0.8741071565083169, 0.8508610084861004, 0.8620054969777607],
                  "r2_final": [0.8108496298737657, -0.2905049013448826, 0.9346782630758341, 0.9830934108827071, 0.9733035946801649, 0.9811070505781108, 0.901555191431124, 0.9787953811705191]},
        "bio_12": {"kept": ["bnv", "bv", "bv", "bv", "bnv", "bv", "bnv", "bv"],
                  "r2_ensemble": [0.8199984500250836, 0.7846582091243741, 0.8044227088012204, 0.7797176184251255, 0.793385474878404, 0.7982923360412343, 0.7975894088942056, 0.789622286978422],
                  "r2_final": [0.9969167350325132, 0.9901189330106119, 0.9351270583848246, 0.9974872875652055, 0.982893801077251, 0.9970925239055869, 0.9976143556024076, 0.9859297910182641]},
    },
    {
        "bio_1": {"kept": ["bnv", "bnv", "bnv", "bnv", "bnv", "bnv", "bnv", "bn"],
                  "r2_ensemble": [0.953844924442656, 0.9475899391937029, 0.9445847833210695, 0.9530479350432126, 0.9492290106101786, 0.9515684246917745, 0.9502166828115837, 0.9635462574717697],
                  "r2_final": [0.9909151962202486, 0.9933506104358264, 0.9941942550554577, 0.991658850429333, 0.9912178502706024, 0.9873806801663946, 0.9929508356356447, 0.8669648696824659]},
        "bio_12": {"kept": ["bnv", "bgnv", "bnv", "bgnv", "bnv", "bnv", "bnv", "bnv"],
                  "r2_ensemble": [0.7905098893611036, 0.7814591747937355, 0.8008228111501021, 0.80240050473843, 0.7983478487749767, 0.8022723860951476, 0.780010310782875, 0.7856036616988832],
                  "r2_final": [0.8137975710135371, 0.8426770165242186, 0.8278555119817095, 0.8515248094746787, 0.783225958930334, 0.859368743483212, 0.8293465169043217, 0.8368997400558882]},
    },
    {
        "bio_1": {"kept": ["bg", "b", "bn", "b", "bg", "bgn", "b", "bnm"],
                  "r2_ensemble": [0.8644284486138385, 0.8933958050819498, 0.9064775853118636, 0.892897028380158, 0.8547416720731684, 0.879620672820727, 0.8920650319381678, 0.8832842854487069],
                  "r2_final": [0.7856159521838412, -2.402325900362441, -0.04563509941665589, -2.087970992832901, 0.9853111192038964, 0.6923764283097844, -2.4057696523016663, 0.670925065611579]},
        "bio_12": {"kept": ["bn", "b", "bn", "b", "bn", "bn", "b", "bm"],
                  "r2_ensemble": [0.8883882431100275, 0.8815815454756385, 0.8898886444755321, 0.8785603728127865, 0.899915940606822, 0.8955076184595593, 0.8944303432590661, 0.8819693204945331],
                  "r2_final": [0.9203993069731216, 0.9540381222626136, 0.9713723995370331, 0.9016169945357795, 0.9810345960744341, 0.9557175159864743, 0.8380470996582846, 0.9784959015010158]},
    },
]
# the card's merge of the read-back finals against the same merge on the CPU,
# of max |surface|: the same float32 arithmetic in another order
MERGE_TOL = 1e-6

# The JAX package's values for mltps over the BRT + NN pool ("bn"; covariates
# as built, float32; folds from numpy_folds(813, 10, 2, seed=0)), PRNG keys
# 0-3, from `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_bn_r2.py
# --keys 0,1,2,3 1` (CPU, 621-765 s a key on an 8-core CPU).  The NN inits
# and the BRT bags are threefry draws there and torch draws here, so each r²
# is held to the keys' mean within max(R2_TOL_B, 3 x their spread): 0.01,
# except bio_12's r² final (spread 0.0048, band 0.0144).  Every key keeps "bn".
JAX_REFERENCE_BN = {
    "bio_1": {"kept": ["bn", "bn", "bn", "bn"],
              "r2_ensemble": [0.9377469242168024, 0.9384933971351264, 0.9379402536395949, 0.9369282534719621],
              "r2_final": [0.9961758347269227, 0.9952700305942918, 0.9949255486601413, 0.9955741609029347]},
    "bio_12": {"kept": ["bn", "bn", "bn", "bn"],
               "r2_ensemble": [0.864729689245973, 0.866564214101987, 0.864604333349729, 0.8668480478917979],
               "r2_final": [0.9352715248713949, 0.9332426796888509, 0.9380290753875588, 0.9343755069879693]},
}
# The NN's L-BFGS, card against CPU in float64 at the CV shape, of the
# responses' range.  After 50 steps the two part by 5.8e-7 of the range (H100
# run): the same arithmetic in another summation order (cuBLAS against the
# CPU's reductions), amplified by the training itself, which multiplies a
# relative perturbation of 1e-15 in the inits into 2.3e-8 after 50 steps and
# 1.2e-13 after 10 (CPU, float64, these lanes).  So the 50-step check holds
# to 1e-5 (1e-7 widened, for that cause), and a 10-step check, before the
# amplification, holds the step sequence to 1e-9.
NN_TOL, NN_TOL_EARLY = 1e-5, 1e-9
NN_STEPS_CHECK, NN_STEPS_EARLY, NN_STEPS_TIMED = 50, 10, 200

# The JAX package's values for the north-star call (the default pool; covariates
# as built, float32; folds from numpy_folds(813, 10, 2, seed=0)), PRNG keys 0-3,
# from `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_main_r2.py
# --keys 0,1,2,3 1` (CPU, 731-869 s a key on an 8-core CPU).  The bags, inits,
# sigest pairs and bootstrap draws are threefry draws there and torch draws
# here, so each r² is held to the keys' mean within max(R2_TOL_B, 3 x their
# spread): 0.01, except bio_12's r² final (spread 0.0048, band 0.0143).  Every
# key keeps "bn", with RF and SVM at weight 0 (no key ran the RF finals).
JAX_REFERENCE_MAIN = {
    "bio_1": {"kept": ["bn", "bn", "bn", "bn"],
              "r2_ensemble": [0.9374573331419003, 0.9385583187222053, 0.9380080374940384, 0.9372275173388972],
              "r2_final": [0.9959510782976777, 0.9952605762203365, 0.9948814059705463, 0.9953915118820694]},
    "bio_12": {"kept": ["bn", "bn", "bn", "bn"],
               "r2_ensemble": [0.8648265456252783, 0.8660241190387852, 0.8642666644826565, 0.8669479996356637],
               "r2_final": [0.9352243489542087, 0.9333218733942671, 0.9380813708816351, 0.9343377943281279]},
}
# The JAX package's values for the single-response north-star call (bio_1
# alone, the default pool; covariates as built, float32; folds from
# numpy_folds(813, 10, 1, seed=0)), PRNG keys 0-3, from
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_one_r2.py --keys 0,1,2,3 1`
# (CPU, 421-481 s a key on an 8-core CPU; every key keeps "bn", and its
# serial gbm.step final grows all 10,000 trees).  Held as the north-star
# call's values are: r² ensemble spread 0.0081 (band 0.0242), r² final
# spread 0.0012 (band 0.01).
JAX_REFERENCE_ONE = {
    "bio_1": {"kept": ["bn", "bn", "bn", "bn"],
              "r2_ensemble": [0.9372071484209508, 0.9390379442562601, 0.9376842014273643, 0.930968240690228],
              "r2_final": [0.9954626966860011, 0.9951537584149973, 0.9959163844553077, 0.9963795426042209]},
}
# K4 against its plain version on the card, of C (= 1, the bound of |theta|):
# the same steps with the dot products summed in another order.  One step's
# rounding is ~n eps |q| |theta|; the sweep is a contraction, so it does not
# grow by the step count: float32 ~1e-5, float64 ~1e-13.
SVM_TOL = {"float32": 1e-3, "float64": 1e-9}
SVM_EPOCHS = 120
# K4's shapes, (lanes, stations, sweeps): the SVM's CV (20 (response x fold)
# lanes), its finals (one lane a response), and 4096 stations at a few sweeps
SVM_SHAPES = {"cv": (20, 813, SVM_EPOCHS), "finals": (2, 813, SVM_EPOCHS), "many": (20, 4096, 4)}
SVM_RUNS = (("cv", "float32"), ("cv", "float64"), ("finals", "float32"), ("finals", "float64"), ("many", "float32"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_OPS = 67e12
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    from machisplin_tpu_torch.kernels import build

    from machisplin_tpu_torch.io.native import load_native

    t0 = time.perf_counter()
    libs = build.build_all()
    for name, text in build.ptxas_info().items():
        log.info("nvcc %s:\n%s", name, text)
    _zlib_header()                 # says so on its own line where the compiler finds no zlib.h
    host = load_native()           # the host library, with g++, before any rank starts
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(os.path.relpath(p) for p in libs.values()),
          "host_library": None if host is None else os.path.relpath(host._name)})


def _largest_tile():
    """The largest fit tile of the main path's tiling, the stations in it,
    and their knot budget (as _batched_tile_surfaces packs them)."""
    import numpy as np

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig, _tps_tiles

    grid = mtt.example_grid(1)
    _, _, fit_exts, _ = _tps_tiles(grid, MLTPSConfig())
    tiles = [grid.subgrid(*grid.window_from_extent(e)) for e in fit_exts]
    g = max(tiles, key=lambda t: t.ncell)
    s = mtt.load_sampling()
    row, col = g.rowcol_from_xy(s["long"], s["lat"])
    sel = (row >= 0) & (row < g.nrows) & (col >= 0) & (col < g.ncols)
    coords = np.stack([s["long"], s["lat"]], 1)[sel]
    ys = np.stack([s["bio_1"], s["bio_12"]], 1)[sel]
    return g, coords, ys, -(-int(sel.sum()) // 64) * 64


def k1_tables():
    """K1's tables on the card for the largest tile, as the main path builds
    them: a spline fitted to the tile's stations packed to their knot budget
    (float64), then float32 tables.  Returns (tables, grid, stations,
    budget)."""
    import torch

    from machisplin_tpu_torch.ops import tps_grid
    from machisplin_tpu_torch.parallel.sharded import batched_tile_solve, pack_tiles

    g, coords, ys, budget = _largest_tile()
    ct, yt, mt_ = pack_tiles([coords], [ys], pad_to=budget, dtype=torch.float64, device="cuda")
    model = batched_tile_solve(ct, yt, mt_)
    model = type(model)(*(a[0] for a in model))
    return tps_grid.grid_tables(model, g, torch.float32), g, len(coords), budget


def phase_kernel_k1():
    import torch

    from machisplin_tpu_torch.ops import tps_grid

    t0 = time.perf_counter()
    tab, g, n_knots, budget = k1_tables()
    # the function needs only the live stations: the tables leave out the
    # budget's padded knots (c = 0) and pad the rest to the unroll width
    n_resp, n_pad = tab.c.shape

    got = tps_grid.tps_grid_cuda(tab, g)
    want = tps_grid.tps_grid_plain(tab, g, block_rows=64)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError("K1 produced non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ms = cuda_ms(lambda: tps_grid.tps_grid_cuda(tab, g), reps=10)
    plain_ms = cuda_ms(lambda: tps_grid.tps_grid_plain(tab, g, block_rows=64), reps=5)

    cells = g.ncell
    pairs = cells * n_knots
    ops = pairs * (8 + 2 * n_resp)  # 2 sub, 3 for r2, max, log, mul, 2R accumulate
    nbytes = 4 * (n_resp * cells + 2 * n_knots + n_resp * n_knots + 3 * n_resp)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    res = {
        "phase": "kernel_k1", "seconds": time.perf_counter() - t0,
        "tile": [g.nrows, g.ncols], "cells": cells, "knots": n_knots, "knots_budget": budget, "knots_evaluated": n_pad,
        "responses": n_resp, "phi_pairs": pairs, "phi_evaluated": cells * n_pad,
        "max_abs_err": err, "max_abs_surface": scale, "tolerance": K1_TOL * scale,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ptxas": _ptxas_summary("tps_grid"),
    }
    emit(res)
    if not err <= K1_TOL * scale:
        raise RuntimeError(f"K1 disagrees with its plain version: {err} > {K1_TOL} * {scale}")
    return res


def phase_mltps_gm(dtype: str):
    """The main path with the covariates in ``dtype`` ("float32" as built,
    or "float64"), held to the JAX package's values for that dtype."""
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    cov = mtt.Raster(cov.data.to(getattr(torch, dtype)), cov.grid, cov.names)
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    t_setup = time.perf_counter() - t0

    timer = mtt.PhaseTimer()
    _reset_launches()
    t1 = time.perf_counter()
    out = mtt.mltps(s, cov, tps=True, config=MLTPSConfig(letters_pool="gm"), folds=folds,
                    device="cuda", timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _read_launches()

    mask = torch.isfinite(cov.data).all(0)
    layers, failures = {}, []
    for r in out:
        for attr in ("final", "ensemble", "tps_surface"):
            d = getattr(r, attr).data
            if tuple(d.shape) != cov.grid.shape or not torch.isfinite(d[mask]).all():
                failures.append(f"{r.name}.{attr} is not finite over the covariate mask")
        ref = JAX_REFERENCE[dtype][r.name]
        got = {
            "kept": r.summary["best model(s):"], "weights": r.weights.weights.tolist(),
            "percent": r.summary["ensemble weights:"],
            "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"],
        }
        layers[r.name] = got
        if dtype == "float64" and got["kept"] != ref["kept"]:
            failures.append(f"{r.name} kept {got['kept']!r}, the JAX package keeps {ref['kept']!r}")
        for key in ("r2_ensemble", "r2_final"):
            if not abs(got[key] - ref[key]) <= R2_TOL[dtype]:
                failures.append(f"{r.name} {key} {got[key]} vs the JAX package's {ref[key]}")
    emit({
        "phase": "mltps_gm" if dtype == "float32" else "mltps_gm_f64",
        "seconds": time.perf_counter() - t0, "setup_s": t_setup,
        "mltps_wall_s": wall, "grid": list(cov.grid.shape), "stations": n,
        "dtype": str(cov.data.dtype), "phases_s": timer.as_dict(),
        "launches": launches, "layers": layers, "jax_reference": JAX_REFERENCE[dtype],
        "r2_tol": R2_TOL[dtype],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if launches["tps_grid"] < 6:
        failures.append(f"K1 launched {launches['tps_grid']} times on the main path, expected one per live tile (6)")
    if failures:
        raise RuntimeError("; ".join(failures))
    return launches


def _reset_launches():
    from machisplin_tpu_torch.ops import forest, svm_sweep, tps_grid, tree_grow

    for counts in (tps_grid.LAUNCHES, tree_grow.LAUNCHES, forest.LAUNCHES, svm_sweep.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _read_launches() -> dict:
    from machisplin_tpu_torch.ops import forest, svm_sweep, tps_grid, tree_grow

    return {**tps_grid.LAUNCHES, **tree_grow.LAUNCHES, **forest.LAUNCHES, **svm_sweep.LAUNCHES}


def _stations(device="cuda"):
    """Station covariates (float32, as built) and responses of the main path."""
    import numpy as np

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.pipeline.mltps import _prepare_inputs

    cov = mtt.synthetic_covariates(downsample=1, device=device)
    _, _, _, x_np, responses = _prepare_inputs(mtt.load_sampling(), cov)
    return x_np.astype(np.float32), np.stack(list(responses.values()), 1)


def _ptxas_summary(name: str) -> list:
    from machisplin_tpu_torch.kernels import build

    return [ln.strip() for ln in build.ptxas_info().get(name, "").splitlines()
            if "registers" in ln or "spill" in ln]


def _k2_work(xb, trees, nb, update_ops, gain_ops=12):
    """Operations K2's function needs for these grown trees, (T, C, .)
    arrays (feat, thr, internal, left), over (n, p) bins or (C, n, p) bins
    of each chain: per tree of a chain, the root's histogram (4 hi/lo adds
    per row and feature) and ``gain_ops``-operation gains over the p * nb
    candidates (12; 17 with the monotone check's two divisions, difference,
    product and test); per split, the parent's rows' histograms (4 adds per
    row and feature), two children's gains and one routing test per row;
    ``update_ops`` per row for the update after the tree (and its deviance
    sums)."""
    import numpy as np

    from machisplin_tpu_torch.ops.tree_grow import split_sequence

    n, p = xb.shape[-2:]
    feat, thr, internal, left = trees
    ops = 0
    for t in range(feat.shape[0]):
        for c in range(feat.shape[1]):
            xbc = xb[c] if xb.ndim == 3 else xb
            cur = np.zeros(n, np.int64)
            ops += 4 * n * p + gain_ops * p * nb + update_ops * n
            for k, (q, f, b) in enumerate(split_sequence(feat[t, c], thr[t, c], internal[t, c], left[t, c])):
                rows = cur == q
                m = int(rows.sum())
                ops += 4 * m * p + 2 * gain_ops * p * nb + m
                cur[rows] = np.where(xbc[rows, f] <= b, 2 * k + 1, 2 * k + 2)
    return ops


def _k2_cycle_bytes(n, p, nb, c, n_trees, n_splits, *, emit, scaled, deviance, n_tables=1, order_bytes=2):
    """Bytes a cycle of ``n_trees`` trees must move, each input read once and
    each output written once: the bins, sorted rows and bin offsets of each
    of ``n_tables`` tables, y, f in and out (and the deviance weights and
    monotone signs) once a cycle; each tree's bags (and scale, tree arrays
    and deviance sums)."""
    once = (n_tables * ((1 + order_bytes) * p * n + 4 * p * (nb + 1)) + 3 * 4 * c * n
            + (2 * 4 * c * n if deviance else 0))
    per_tree = (4 * c * n + (4 * c if scaled else 0) + (4 * c * (6 * (2 * n_splits + 1) + p) if emit else 0)
                + (2 * 4 * c if deviance else 0))
    return once + n_trees * per_tree


def k2_inputs() -> dict:
    """K2's inputs at the BRT path's shapes, on the card: the stations' bins
    and their tables, and per shape y, w, n_splits, lr and emit (the CV
    curve's 200 chains at tree complexity 25; the finals' 20 chains at tree
    complexity 5, emitting trees).  Seeded."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import gbm_step, trees as ttrees
    from machisplin_tpu_torch.ops import tree_grow

    x_np, ys = _stations()
    n = x_np.shape[0]
    x = torch.as_tensor(x_np, device="cuda")
    nb = 64
    xb = ttrees.bin_data(x, ttrees.make_bins(x, nb))
    gen = torch.Generator().manual_seed(1)
    ycols = torch.as_tensor(ys, dtype=torch.float32, device="cuda")           # (n, 2)

    # CV shape: (response, outer fold) chains, each with 10 inner folds
    folds = torch.as_tensor(numpy_folds(n, 10, 2, seed=0), device="cuda")    # (2, n)
    outer = (folds[:, None, :] != torch.arange(10, device="cuda")[None, :, None]).float().reshape(20, n)
    y_outer = ycols.T.repeat_interleave(10, dim=0)                            # (20, n)
    sel = gbm_step._draw_selectors(gen, outer, 10)
    cv_w = ((sel[:, None, :] != torch.arange(10, device="cuda")[None, :, None]).float()
            * outer[:, None, :]).reshape(200, n)
    cv_y = y_outer.repeat_interleave(10, dim=0)
    # finals' shape: every response's 10 inner folds over all rows
    sel_f = torch.as_tensor(np.stack([gbm_step._make_selector(gen, ys[:, j], np.ones(n), 10) for j in range(2)]),
                            device="cuda").long()
    fin_w = (sel_f[:, None, :] != torch.arange(10, device="cuda")[None, :, None]).float().reshape(20, n)
    fin_y = ycols.T.repeat_interleave(10, dim=0)
    return {"xb": xb, "tables": tree_grow.prepare_bins(xb, nb), "nb": nb, "min_leaf": 10.0, "shapes": {
        "cv": dict(y=cv_y.contiguous(), w=cv_w.contiguous(), n_splits=25, lr=0.01, emit=False),
        "finals": dict(y=fin_y.contiguous(), w=fin_w.contiguous(), n_splits=5, lr=0.001, emit=True),
    }}


def k2_cycle_kwargs(sh, nb, min_leaf, n_trees) -> dict:
    """A cycle's keywords as the BRT path launches it at shape ``sh``: the
    CV curve's ``f + lr v``, or the finals' lr = 1 with ``scale`` lr,
    emitting trees and the training and holdout deviance sums."""
    import torch

    kw = dict(n_splits=sh["n_splits"], nb=nb, min_leaf=min_leaf, lr=sh["lr"])
    if sh["emit"]:
        w = sh["w"]
        kw.update(lr=1.0, emit_tree=True, scale=torch.full((n_trees, w.shape[0]), sh["lr"], device=w.device),
                  deviance_w=torch.stack([w, (w <= 0).float()]).contiguous())
    return kw


def _k2_cycle_vs_single(tables, y, f, bags, kw) -> dict:
    """One launch of a T-tree cycle against T one-tree launches of the same
    kernel on the same inputs: every output bit-identical."""
    import torch

    from machisplin_tpu_torch.ops import tree_grow

    before = dict(tree_grow.LAUNCHES)
    cyc = tree_grow.gbm_tree_cycle_cuda(tables, y, f, bags, **kw)
    torch.cuda.synchronize()
    launches = {k: tree_grow.LAUNCHES[k] - before[k] for k in before}
    fs, trees, devs = f, [], []
    for t in range(bags.shape[0]):
        one = dict(kw, scale=None if kw.get("scale") is None else kw["scale"][t : t + 1])
        out = tree_grow.gbm_tree_cycle_cuda(tables, y, fs, bags[t : t + 1], **one)
        fs = out.f
        trees.append(out.trees)
        devs.append(out.deviance)
    torch.cuda.synchronize()
    same = [torch.equal(cyc.f, fs)]
    if cyc.trees is not None:
        same += [torch.equal(cyc.trees[k], torch.cat([tr[k] for tr in trees])) for k in range(7)]
    if cyc.deviance is not None:
        same.append(torch.equal(cyc.deviance, torch.cat(devs)))
    return {"trees": int(bags.shape[0]), "identical": all(same), "outputs_compared": len(same),
            "cycle_launches": launches}


def phase_kernel_k2():
    """K2 against its plain version at the CV and the finals' shapes, one
    tree at a time and a 50-tree cycle as the path launches it; the cycle
    against 50 one-tree launches; times per tree."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.models import trees as ttrees
    from machisplin_tpu_torch.ops import tree_grow

    t0 = time.perf_counter()
    inp = k2_inputs()
    xb, tables, nb, min_leaf = inp["xb"], inp["tables"], inp["nb"], inp["min_leaf"]
    n, p = (int(d) for d in xb.shape)
    cum1h = ttrees.flat_bin_cum_onehot(xb, nb)
    plain_tables = tables._replace(cum1h=cum1h)
    segments = (tables.offsets[:, 1:] - tables.offsets[:, :-1]).cpu().numpy()
    xb_np = xb.cpu().numpy()
    res = {"phase": "kernel_k2", "stations": n, "features": p, "nb": nb,
           "tie_gap": TIE_GAP, "tol": K2_TOL, "dev_rtol": K2_DEV_RTOL, "ptxas": _ptxas_summary("tree_grow"),
           "bin_rows_longest": int(segments.max()), "bin_rows_mean": float(segments.mean()), "shapes": {}}
    failures = []
    g_dev = torch.Generator(device="cuda").manual_seed(2)
    for name, sh in inp["shapes"].items():
        y, w, n_splits, lr, emit_tree = sh["y"], sh["w"], sh["n_splits"], sh["lr"], sh["emit"]
        c = y.shape[0]
        kw = dict(n_splits=n_splits, nb=nb, min_leaf=min_leaf)
        f = ((w * y).sum(1) / w.sum(1).clamp_min(1.0))[:, None].expand(c, n).contiguous()
        checks = []
        for step in range(301):
            bag = (torch.rand((c, n), generator=g_dev, device="cuda") < 0.5).float() * w
            if step in (0, 300):
                got = tree_grow.gbm_tree_cycle(tables, y, f, bag[None], lr=lr, emit_tree=True, **kw)
                want = tree_grow.gbm_tree_update_plain(xb.T, cum1h, y, f, bag, lr=lr, emit_tree=True, **kw)
                torch.cuda.synchronize()
                got_np = [got.f.cpu().numpy()] + [a[0].cpu().numpy() for a in got.trees]
                want_np = [a.cpu().numpy() for a in want]
                r = (y - f).cpu().numpy()
                bag_np = bag.cpu().numpy()
                same, gaps, err = 0, [], 0.0
                for ch in range(c):
                    gap = tree_grow.near_tie_gap(
                        xb_np, r[ch], bag_np[ch], [want_np[k][ch] for k in (1, 2, 3, 4)],
                        [got_np[k][ch] for k in (1, 2, 3, 4)], nb=nb, min_leaf=min_leaf)
                    if gap is None:
                        same += 1
                        err = max(err, float(np.abs(got_np[0][ch] - want_np[0][ch]).max()))
                    else:
                        gaps.append(gap)
                scale = float(np.abs(r).max())
                checks.append({"step": step, "chains": c, "identical_trees": same,
                               "differing_gaps": sorted(gaps), "max_abs_err": err, "scale": scale})
                if not all(g <= TIE_GAP for g in gaps):
                    failures.append(f"K2 {name} step {step}: trees part away from a near-tie {max(gaps)}")
                if not err <= K2_TOL * scale:
                    failures.append(f"K2 {name} step {step}: f differs by {err} > {K2_TOL} * {scale}")
            f = tree_grow.gbm_tree_cycle(tables, y, f, bag[None], lr=lr, **kw).f
        # a cycle as the main path launches it: the CV's update, or the
        # finals' scaled update with trees and deviance sums
        bags = (torch.rand((K2_CYCLE, c, n), generator=g_dev, device="cuda") < 0.5).float() * w
        ckw = k2_cycle_kwargs(sh, nb, min_leaf, K2_CYCLE)
        cycle = _k2_cycle_vs_single(tables, y, f, bags, ckw)
        if not cycle["identical"]:
            failures.append(f"K2 {name}: a {K2_CYCLE}-tree cycle differs from {K2_CYCLE} one-tree launches")
        if cycle["cycle_launches"] != {"tree_grow": 1, "tree_grow_trees": K2_CYCLE}:
            failures.append(f"K2 {name}: the cycle counted {cycle['cycle_launches']}")
        # the same cycle with its trees, against the plain version grown from the same inputs
        grown = tree_grow.gbm_tree_cycle_cuda(tables, y, f, bags, **dict(ckw, emit_tree=True))
        agree = tree_grow.cycle_agreement(xb, y, f, bags, grown, cum1h=cum1h,
                                          **{k: v for k, v in ckw.items() if k != "emit_tree"})
        bad = [g for g in agree["gaps"] if not g[2] <= TIE_GAP]
        if bad:
            failures.append(f"K2 {name} cycle: trees part from the plain version away from a near-tie: {bad[:5]}")
        if not agree["identical_chains"] > 0:
            failures.append(f"K2 {name} cycle: no chain's {K2_CYCLE} trees all agree with the plain version")
        if not agree["max_abs_err"] <= K2_TOL * agree["resid_scale"]:
            failures.append(f"K2 {name} cycle: f differs by {agree['max_abs_err']} > {K2_TOL} * "
                            f"{agree['resid_scale']}")
        dev_err = agree["max_rel_err_deviance"]
        if "deviance_w" in ckw and not dev_err <= K2_DEV_RTOL:
            failures.append(f"K2 {name} cycle: deviance sums differ by {dev_err} > {K2_DEV_RTOL} (relative)")
        splits = grown.trees[2].sum(-1).amax(1).mean().item()     # per tree, the chain that split most
        cycle_ms = cuda_ms(lambda: tree_grow.gbm_tree_cycle_cuda(tables, y, f, bags, **ckw), reps=10)
        single_ms = cuda_ms(lambda: tree_grow.gbm_tree_cycle(tables, y, f, bag[None], lr=lr, emit_tree=emit_tree,
                                                             **kw), reps=20)
        plain_ms = cuda_ms(lambda: tree_grow.gbm_tree_cycle_plain(plain_tables, y, f, bags, **ckw), reps=1)
        update_ops = 2 + (3 + 6 if emit_tree else 0)   # f + lr v; the finals' scaled update and deviance sums
        ops = _k2_work(xb_np, [a.cpu().numpy() for a in grown.trees[:4]], nb, update_ops) / K2_CYCLE
        nbytes = _k2_cycle_bytes(n, p, nb, c, K2_CYCLE, n_splits, emit=emit_tree, scaled="scale" in ckw,
                                 deviance="deviance_w" in ckw) / K2_CYCLE
        t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms = cycle_ms / K2_CYCLE
        res["shapes"][name] = {
            "chains": c, "n_splits": n_splits, "emit_tree": emit_tree, "checks": checks, "cycle_check": cycle,
            "plain_cycle_check": dict(agree, gaps=sorted(g[2] for g in agree["gaps"])),
            "smem_bytes": tree_grow.smem_bytes(n, p, nb, n_splits),
            "max_abs_err": max([ch["max_abs_err"] for ch in checks] + [agree["max_abs_err"]]),
            "ms": ms, "cycle_ms": cycle_ms, "single_launch_ms": single_ms,
            "splits_per_tree": splits, "ms_per_dependent_pass": ms / (splits + 1),
            "plain_ms": plain_ms / K2_CYCLE, "ops": ops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    res["extended"] = _k2_extended_checks(inp, failures)
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def _ptxas_entries(name: str) -> dict:
    """ptxas's registers and spills of each kernel entry in csrc/<name>.cu,
    keyed by the entry's mangled name."""
    from machisplin_tpu_torch.kernels import build

    out, entry = {}, None
    for ln in build.ptxas_info().get(name, "").splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif entry and ("registers" in ln or "spill" in ln):
            out.setdefault(entry, []).append(ln.strip().split("ptxas info    : ")[-1])
    return out


def _k2_ptxas(rows_global: bool, order_bytes: int = 2) -> list:
    """ptxas's lines of the K2 instance a layout launches
    (tree_grow_kernel<GLOBAL_ROWS, OrderT>)."""
    tag = "ILb0EsE" if not rows_global else ("ILb1EsE" if order_bytes == 2 else "ILb1EiE")
    return [ln for entry, lines in _ptxas_entries("tree_grow").items() if tag in entry for ln in lines]


def seeded_stations(n: int, seed: int = 0):
    """``n`` stations at seeded places on the full grid (numpy's
    default_rng(seed), uniform over the grid's extent, those on a cell with
    every covariate kept): covariates alt, slope, TWI, LONG, LAT as the main
    path extracts them (float32, as built) and a response like bio_1
    (a lapse rate of 5.5 degrees a kilometre, a latitude trend and noise)."""
    import numpy as np

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.pipeline.mltps import _prepare_inputs

    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    xmin, xmax, ymin, ymax = cov.grid.extent
    rng = np.random.default_rng(seed)
    m = 2 * n
    lon, lat = rng.uniform(xmin, xmax, m), rng.uniform(ymin, ymax, m)
    table = np.rec.fromarrays([lon, lat, np.zeros(m)], names="long,lat,y")
    _, _, coords, x_np, _ = _prepare_inputs(table, cov)
    x_np = x_np[:n].astype(np.float32)
    y = 28.0 - 0.0055 * x_np[:, 0] + 0.3 * (x_np[:, 4] - x_np[:, 4].mean()) + rng.normal(0, 0.5, len(x_np))
    return x_np, y.astype(np.float32)


def _k2_timed(tables, y, f, bags, kw, xb_np, plain_tables, *, gain_ops=12, n_tables=1, order_bytes=2, rows="auto"):
    """CUDA-event ms a tree of K2 through one launch of the cycle ``bags``,
    the plain version's ms a tree on the same cycle, and the bound of the
    work these trees need (bytes and operations)."""
    from machisplin_tpu_torch.ops import tree_grow

    n_trees, c, n = bags.shape
    p = xb_np.shape[-1]
    grown = tree_grow.gbm_tree_cycle_cuda(tables, y, f, bags, **dict(kw, emit_tree=True), rows=rows)
    ms = cuda_ms(lambda: tree_grow.gbm_tree_cycle_cuda(tables, y, f, bags, **kw, rows=rows), reps=5) / n_trees
    plain_ms = cuda_ms(lambda: tree_grow.gbm_tree_cycle_plain(plain_tables, y, f, bags, **kw), reps=1) / n_trees
    ops = _k2_work(xb_np, [a.cpu().numpy() for a in grown.trees[:4]], kw["nb"], 2, gain_ops) / n_trees
    nbytes = _k2_cycle_bytes(n, p, kw["nb"], c, n_trees, kw["n_splits"], emit=False, scaled=False, deviance=False,
                             n_tables=n_tables, order_bytes=order_bytes) / n_trees
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    splits = grown.trees[2].sum(-1).amax(1).mean().item()
    return grown, {"ms": ms, "plain_ms": plain_ms, "ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes", "splits_per_tree": splits,
                   "ms_per_dependent_pass": ms / (splits + 1)}


def _k2_agree_check(name, agree, failures, tie_gap=TIE_GAP) -> dict:
    bad = [g for g in agree["gaps"] if not g[2] <= tie_gap]
    if bad:
        failures.append(f"K2 {name}: trees part from the plain version away from a near-tie: {bad[:5]}")
    if not agree["identical_chains"] > 0:
        failures.append(f"K2 {name}: no chain's trees all agree with the plain version")
    if not agree["max_abs_err"] <= K2_TOL * agree["resid_scale"]:
        failures.append(f"K2 {name}: f differs by {agree['max_abs_err']} > {K2_TOL} * {agree['resid_scale']}")
    return dict(agree, gaps=sorted(g[2] for g in agree["gaps"]))


def _k2_extended_checks(inp, failures) -> dict:
    """K2 beyond the batched BRT's shapes: bin tables per chain (the serial
    gbm.step's 10 CV folds, each on its own training rows, tree complexity
    5), gbm's monotone check (the finals' shape with signs), the rows in
    device memory forced at the CV shape (bit-identical to shared memory),
    and the station counts whose rows do not fit shared memory: 200 chains
    x K2_CEILING stations x p = 5 x tree complexity 25, and 20 chains x
    40,000 stations x tree complexity 5.  Each a K2_CYCLE-tree cycle against
    the plain version, with ms a tree, its bound and ptxas's lines."""
    import torch

    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import trees as ttrees
    from machisplin_tpu_torch.ops import tree_grow

    out = {}
    nb, min_leaf = inp["nb"], inp["min_leaf"]
    g = torch.Generator(device="cuda").manual_seed(3)
    bag_draw = lambda shape, w: (torch.rand((K2_CYCLE,) + shape, generator=g, device="cuda") < 0.5).float() * w

    # per-chain bins: 10 folds of the stations, each binned on its own training rows
    x_np, ys = _stations()
    x = torch.as_tensor(x_np, device="cuda")
    n, p = x_np.shape
    folds = torch.as_tensor(numpy_folds(n, 10, 1, seed=0)[0], device="cuda")
    train = (folds[None, :] != torch.arange(10, device="cuda")[:, None]).float()
    xb_k = ttrees.bin_data(x, ttrees.make_bins_masked(x, train, nb))
    tables_k = tree_grow.prepare_bins(xb_k, nb)
    plain_k = tables_k._replace(cum1h=ttrees.flat_bin_cum_onehot(xb_k, nb))
    y = torch.as_tensor(ys[:, 0], dtype=torch.float32, device="cuda")[None].expand(10, n).contiguous()
    f = ((train * y).sum(1) / train.sum(1))[:, None].expand(10, n).contiguous()
    bags = bag_draw((10, n), train)
    kw = dict(n_splits=5, nb=nb, min_leaf=min_leaf, lr=0.001)
    grown, timed = _k2_timed(tables_k, y, f, bags, kw, xb_k.cpu().numpy(), plain_k, n_tables=10)
    agree = tree_grow.cycle_agreement(xb_k, y, f, bags, grown, cum1h=plain_k.cum1h, **kw)
    out["per_chain_bins"] = {"chains": 10, "stations": n, "n_splits": 5, **timed,
                             "plain_cycle_check": _k2_agree_check("per-chain bins", agree, failures),
                             "ptxas": _k2_ptxas(False)}

    # monotone: the finals' shape with a sign on every covariate but LONG
    fin = inp["shapes"]["finals"]
    mono = torch.tensor([-1.0, 1.0, 1.0, 0.0, -1.0], device="cuda")
    y, w = fin["y"], fin["w"]
    c = y.shape[0]
    f = ((w * y).sum(1) / w.sum(1))[:, None].expand(c, n).contiguous()
    bags = bag_draw((c, n), w)
    kw = dict(n_splits=5, nb=nb, min_leaf=min_leaf, lr=0.001, monotone=mono)
    plain = inp["tables"]._replace(cum1h=ttrees.flat_bin_cum_onehot(inp["xb"], nb))
    grown, timed = _k2_timed(inp["tables"], y, f, bags, kw, inp["xb"].cpu().numpy(), plain, gain_ops=17)
    agree = tree_grow.cycle_agreement(inp["xb"], y, f, bags, grown, cum1h=plain.cum1h, **kw)
    zero = tree_grow.gbm_tree_cycle_cuda(inp["tables"], y, f, bags, **dict(kw, monotone=torch.zeros_like(mono)),
                                         emit_tree=True)
    free = tree_grow.gbm_tree_cycle_cuda(inp["tables"], y, f, bags, **dict(kw, monotone=None), emit_tree=True)
    zero_same = torch.equal(zero.f, free.f) and all(torch.equal(a, b) for a, b in zip(zero.trees, free.trees))
    if not zero_same:
        failures.append("K2: all-zero monotone signs differ from no monotone vector")
    out["monotone"] = {"chains": c, "stations": n, "n_splits": 5, "signs": mono.tolist(), **timed,
                       "zero_signs_bit_identical_to_none": zero_same,
                       "plain_cycle_check": _k2_agree_check("monotone", agree, failures), "ptxas": _k2_ptxas(False)}

    # the rows in device memory, forced at the CV shape: the same bits as shared memory
    cv = inp["shapes"]["cv"]
    y, w = cv["y"], cv["w"]
    c = y.shape[0]
    f = ((w * y).sum(1) / w.sum(1))[:, None].expand(c, n).contiguous()
    bags = bag_draw((c, n), w)
    kw = dict(n_splits=25, nb=nb, min_leaf=min_leaf, lr=0.01)
    shared = tree_grow.gbm_tree_cycle_cuda(inp["tables"], y, f, bags, emit_tree=True, rows="shared", **kw)
    glob = tree_grow.gbm_tree_cycle_cuda(inp["tables"], y, f, bags, emit_tree=True, rows="global", **kw)
    same = torch.equal(shared.f, glob.f) and all(torch.equal(a, b) for a, b in zip(shared.trees, glob.trees))
    if not same:
        failures.append("K2: rows in device memory differ from rows in shared memory at the CV shape")
    _, timed = _k2_timed(inp["tables"], y, f, bags, kw, inp["xb"].cpu().numpy(), plain, rows="global")
    out["global_rows_cv_shape"] = {
        "chains": c, "stations": n, "n_splits": 25, "bit_identical_to_shared": same, **timed,
        "shared_ms": cuda_ms(lambda: tree_grow.gbm_tree_cycle_cuda(inp["tables"], y, f, bags, rows="shared", **kw),
                             reps=5) / K2_CYCLE,
        "smem_bytes": {"shared": tree_grow.smem_bytes(n, p, nb, 25), "global": tree_grow.smem_bytes(n, p, nb, 25, True)},
        "ptxas": _k2_ptxas(True)}

    # the station counts whose rows do not fit shared memory
    for name, (c, n_st, n_splits) in K2_CEILING.items():
        xs, yv = seeded_stations(n_st, seed=n_st)
        xt = torch.as_tensor(xs, device="cuda")
        xb = ttrees.bin_data(xt, ttrees.make_bins(xt, nb))
        tables = tree_grow.prepare_bins(xb, nb)
        order_bytes = tables.order.element_size()
        folds = torch.as_tensor(numpy_folds(n_st, 10, 1, seed=0)[0], device="cuda")
        w = (folds[None, :] != torch.arange(c, device="cuda")[:, None] % 10).float()
        y = torch.as_tensor(yv, device="cuda")[None].expand(c, n_st).contiguous()
        f = ((w * y).sum(1) / w.sum(1))[:, None].expand(c, n_st).contiguous()
        bags = bag_draw((c, n_st), w)
        kw = dict(n_splits=n_splits, nb=nb, min_leaf=min_leaf, lr=0.01)
        plain = tables._replace(cum1h=ttrees.flat_bin_cum_onehot(xb, nb))
        grown, timed = _k2_timed(tables, y, f, bags, kw, xb.cpu().numpy(), plain, order_bytes=order_bytes)
        agree = tree_grow.cycle_agreement(xb, y, f, bags, grown, cum1h=plain.cum1h, **kw)
        # the plain version against itself with the rows permuted (the same
        # function, float32 sums in another order): its own resolution here
        perm = torch.randperm(n_st, generator=torch.Generator().manual_seed(n_st)).cuda()
        xbp = xb[perm]
        selfp = tree_grow.gbm_tree_cycle_plain(
            tables._replace(xbt=xbp.T.contiguous(), cum1h=ttrees.flat_bin_cum_onehot(xbp, nb)), y[:, perm].contiguous(),
            f[:, perm].contiguous(), bags[:, :, perm].contiguous(), emit_tree=True, **kw)
        self_agree = tree_grow.cycle_agreement(xb, y, f, bags, selfp._replace(f=selfp.f[:, torch.argsort(perm)]),
                                               cum1h=plain.cum1h, **kw)
        finite = bool(torch.isfinite(grown.f).all())
        if not finite:
            failures.append(f"K2 {name}: non-finite f")
        parted, parted_self = c - agree["identical_chains"], c - self_agree["identical_chains"]
        if not parted <= 2 * parted_self + 5:
            failures.append(f"K2 {name}: trees part from the plain version in {parted} chains, the plain version "
                            f"from itself with its rows permuted in {parted_self}")
        out[name] = {"chains": c, "stations": n_st, "n_splits": n_splits, "order_bytes": order_bytes,
                     "smem_bytes_shared_layout": tree_grow.smem_bytes(n_st, p, nb, n_splits),
                     "smem_bytes": tree_grow.smem_bytes(n_st, p, nb, n_splits, True), "finite": finite, **timed,
                     "tie_gap": CEILING_TIE_GAP,
                     "plain_cycle_check": _k2_agree_check(name, agree, failures, CEILING_TIE_GAP),
                     "plain_vs_itself_rows_permuted": dict(self_agree, gaps=sorted(g[2] for g in self_agree["gaps"])),
                     "ptxas": _k2_ptxas(True, order_bytes)}
    return out


def phase_cv_b_8000():
    """CV letter b on CV_B_STATIONS seeded stations (rows beyond a block's
    shared memory), with max_trees cut to CV_B_MAX_TREES: finite residuals
    of every station, K2 launched."""
    import numpy as np
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.cv import CVConfig, run_cv
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.ops import tree_grow

    t0 = time.perf_counter()
    x_np, y = seeded_stations(CV_B_STATIONS, seed=CV_B_STATIONS)
    n = len(y)
    brt = dict(CVConfig().brt, max_trees=CV_B_MAX_TREES)
    timer = mtt.PhaseTimer()
    _reset_launches()
    t1 = time.perf_counter()
    res = run_cv(torch.as_tensor(x_np, device="cuda"), torch.as_tensor(y, device="cuda"), config=CVConfig(brt=brt),
                 algorithms="b", folds=numpy_folds(n, 10, 1, seed=0), generator=torch.Generator().manual_seed(0),
                 timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _read_launches()
    resid = res["b"]
    finite = bool(np.isfinite(resid).all())
    out = {"phase": "cv_b_8000", "seconds": time.perf_counter() - t0, "stations": n, "features": int(x_np.shape[1]),
           "max_trees": brt["max_trees"], "max_trees_cut_from": CVConfig().brt["max_trees"], "cv_b_s": wall,
           "residuals": int(resid.shape[0]), "finite": finite, "resid_rms": float(np.sqrt(np.mean(resid**2))),
           "y_sd": float(np.std(y)), "launches": {k: launches[k] for k in tree_grow.LAUNCHES},
           "smem_bytes_shared_layout": tree_grow.smem_bytes(n, int(x_np.shape[1]), 64, brt["tree_complexity"])}
    emit(out)
    if not finite or resid.shape[0] != 9 * n:
        raise RuntimeError(f"cv_b_8000: residuals not finite or not {9 * n} of them ({resid.shape[0]})")
    if launches["tree_grow"] <= 0:
        raise RuntimeError("cv_b_8000: K2 did not launch")
    return out


def phase_mltps_b(captured: dict):
    """The slice's path: mltps over the BRT pool at full size, float32."""
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import gbm_step
    from machisplin_tpu_torch.ops import tree_grow
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    mltps_mod = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    t_setup = time.perf_counter() - t0

    # observe (without changing) what the run builds: the finals' results,
    # the K2 launches before them, and the merged forest's device tables
    fit_multi, prepare = gbm_step.fit_multi, mltps_mod.prepare_forest

    def fit_multi_seen(*a, **kw):
        captured["cv_k2"] = dict(tree_grow.LAUNCHES)
        out = fit_multi(*a, **kw)
        captured["finals"] = [(r.best_trees, r.restarts, r.learning_rate, r.trees_fitted) for r in out]
        return out

    def prepare_seen(*a, **kw):
        captured["forest"] = prepare(*a, **kw)
        captured["forest_trees"], captured["leaf_tables"] = a[0], a[2]
        return captured["forest"]

    gbm_step.fit_multi, mltps_mod.prepare_forest = fit_multi_seen, prepare_seen
    timer = mtt.PhaseTimer()
    try:
        _reset_launches()
        t1 = time.perf_counter()
        out = mtt.mltps(s, cov, tps=True, config=MLTPSConfig(letters_pool="b"), folds=folds,
                        generator=torch.Generator().manual_seed(0), device="cuda", timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = _read_launches()
    finally:
        gbm_step.fit_multi, mltps_mod.prepare_forest = fit_multi, prepare
    captured["stack"] = cov

    mask = torch.isfinite(cov.data).all(0)
    layers, failures = {}, []
    for r in out:
        for attr in ("final", "ensemble", "tps_surface"):
            d = getattr(r, attr).data
            if tuple(d.shape) != cov.grid.shape or not torch.isfinite(d[mask]).all():
                failures.append(f"{r.name}.{attr} is not finite over the covariate mask")
        ref = JAX_REFERENCE_B[r.name]
        got = {"kept": r.summary["best model(s):"], "r2_ensemble": r.summary["r2 ensemble:"],
               "r2_final": r.summary["r2 final:"], "var_imp": r.var_imp}
        layers[r.name] = got
        if got["kept"] != ref["kept"]:
            failures.append(f"{r.name} kept {got['kept']!r}, the JAX package keeps {ref['kept']!r}")
        for key in ("r2_ensemble", "r2_final"):
            if not abs(got[key] - ref[key]) <= R2_TOL_B:
                failures.append(f"{r.name} {key} {got[key]} vs the JAX package's {ref[key]}")
    ft = captured.get("forest")
    cv_k2 = captured.get("cv_k2", {})
    emit({
        "phase": "mltps_b", "seconds": time.perf_counter() - t0, "setup_s": t_setup, "mltps_wall_s": wall,
        "grid": list(cov.grid.shape), "stations": n, "dtype": str(cov.data.dtype), "phases_s": timer.as_dict(),
        "launches": launches, "k2_cv": cv_k2,
        "k2_finals": {k: launches[k] - cv_k2.get(k, 0) for k in ("tree_grow", "tree_grow_trees")},
        "finals_best_trees_restarts_lr_fitted": captured.get("finals"),
        "forest_slots": None if ft is None else int(ft.lo.shape[1]),
        "forest_trees_tabled": None if ft is None else int(ft.desc.shape[0]),
        "forest_loop_slots": None if ft is None else int(ft.loop_slot.numel()),
        "layers": layers, "jax_reference": JAX_REFERENCE_B, "r2_tol": R2_TOL_B, "jax_key_spread": R2_SPREAD_B,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if launches["tps_grid"] != 6:
        failures.append(f"K1 launched {launches['tps_grid']} times on the BRT path, expected 6")
    if launches["tree_grow"] <= 0 or launches["forest_predict"] <= 0:
        failures.append(f"a tree kernel did not run on the BRT path: {launches}")
    if launches["tree_grow_trees"] != K2_CYCLE * launches["tree_grow"]:
        failures.append(f"K2 did not grow {K2_CYCLE}-tree cycles on the BRT path: {launches}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return launches


def k3_panel(cov):
    """The cells of one full-width 256-row panel in the middle of the grid,
    as the raster pass gives them to K3: the covariates and lon/lat, float32,
    non-finite rows set to 0.  Returns (first row, (m, p) cells)."""
    import torch

    from machisplin_tpu_torch.grid import lonlat_rasters, stack

    rs = stack([cov, lonlat_rasters(cov.grid, cov.data.dtype, cov.data.device)])
    r0 = (rs.data.shape[1] // 2) // 256 * 256
    blk = rs.data[:, r0 : r0 + 256, :]
    x = blk.movedim(0, -1).reshape(-1, blk.shape[0]).to(torch.float32)
    return r0, torch.where(torch.isfinite(x).all(1, keepdim=True), x, torch.zeros((), device=x.device))


def _k3_check(ft, x) -> dict:
    """K3 against its plain version on cells ``x``: leaf-membership counts
    (every slot value 1) equal, weighted sums within K3_TOL of sum |w v|."""
    import torch

    from machisplin_tpu_torch.ops import forest

    got = forest.forest_predict_cuda(ft, x)
    want = forest.forest_predict_plain(ft, x)
    ones = ft._replace(wv=torch.ones((ft.wv.shape[0], 1), device=x.device), offset=ft.offset[:1])
    counts = forest.forest_predict_plain(ones, x)
    counts_equal = bool(torch.equal(forest.forest_predict_cuda(ones, x), counts))
    torch.cuda.synchronize()
    err = (got - want).abs().max(0).values
    scale = ft.wv.abs().sum(0)
    return {"trees_tabled": int(ft.desc.shape[0]), "rows_per_tree": int(ft.row_slot.shape[1]),
            "loop_slots": int(ft.loop_slot.numel()), "membership_counts_equal": counts_equal,
            "max_abs_err": err.tolist(), "sum_abs_wv": scale.tolist(), "matches": int(counts.sum()),
            "agrees": counts_equal and bool((err <= K3_TOL * scale).all())}


def _k3_path_work(trees, tables, ft, x, levels=None):
    """What the function needs for these cells (plain routing,
    models/trees.tree_assign): per cell and tree, one compare for each split
    node on the path from the root to the cell's leaf, and one add for each
    nonzero weighted value of the leaf's slot (R where every weight is
    nonzero; the dropped leaf needs none).  ``levels``: the trees' largest
    depth when known (heap-layout trees), else their split count bounds it.
    Returns (compares, adds)."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.models import trees as ttrees

    internal = trees.internal.cpu().numpy() > 0
    left, right = trees.left.cpu().numpy().astype(np.int64), trees.right.cpu().numpy().astype(np.int64)
    n_t, n_nodes = internal.shape
    depth = np.zeros((n_t, n_nodes), np.int64)
    rows = np.arange(n_t)[:, None]
    for _ in range(levels or n_nodes):   # relax until every child sits one below its parent
        for child in (left, right):
            child = np.where(internal, child, 0)     # a leaf's children (none, or out of range) to the root
            depth[rows, child] = np.where(internal, depth + 1, depth[rows, child])
    real = np.flatnonzero(tables.leaf_tree >= 0)
    nnz = np.zeros((n_t, n_nodes), np.int64)
    nnz[tables.leaf_tree[real], tables.leaf_node[real]] = (ft.wv[torch.as_tensor(real, device=ft.wv.device)]
                                                          != 0).sum(1).cpu().numpy()
    dev = x.device
    depth_t, nnz_t = torch.as_tensor(depth, device=dev), torch.as_tensor(nnz, device=dev)
    max_depth = levels or int(internal.sum(1).max())
    chunk = 128                       # trees routed at once: (128, m) int64 routes
    compares = adds = 0
    for t0 in range(0, n_t, chunk):
        part = ttrees.Tree(*(a[t0 : t0 + chunk].to(dev) for a in trees))
        leaf = ttrees.tree_assign(part, x, max_depth)                       # (tc, m)
        compares += int(depth_t[t0 : t0 + chunk].gather(1, leaf).sum())
        adds += int(nnz_t[t0 : t0 + chunk].gather(1, leaf).sum())
    return compares, adds


def _k3_grown_forest(n_splits_list):
    """Trees grown by K2 at the finals' shape (20 chains, stations' bins),
    one K2_CYCLE-tree cycle for each tree complexity in ``n_splits_list``, as one
    Tree of raw thresholds (node arrays padded to the largest), with seeded
    (T, 2) weights."""
    import torch

    from machisplin_tpu_torch.models import trees as ttrees
    from machisplin_tpu_torch.ops import tree_grow

    inp = k2_inputs()
    sh, nb = inp["shapes"]["finals"], inp["nb"]
    x = torch.as_tensor(_stations()[0], device="cuda")
    edges = ttrees.make_bins(x, nb)
    y, w = sh["y"], sh["w"]
    c, n = y.shape
    f = ((w * y).sum(1) / w.sum(1).clamp_min(1.0))[:, None].expand(c, n).contiguous()
    g = torch.Generator(device="cuda").manual_seed(5)
    n_trees, parts = K2_CYCLE, []
    for n_splits in n_splits_list:
        bags = (torch.rand((n_trees, c, n), generator=g, device="cuda") < 0.5).float() * w
        cyc = tree_grow.gbm_tree_cycle(inp["tables"], y, f, bags, n_splits=n_splits, nb=nb, min_leaf=inp["min_leaf"],
                                       lr=1.0, emit_tree=True, scale=torch.full((n_trees, c), sh["lr"], device="cuda"))
        parts.append([a.reshape(n_trees * c, -1) for a in cyc.trees])
    n_nodes = max(pt[0].shape[1] for pt in parts)
    pad = lambda a: torch.nn.functional.pad(a, (0, n_nodes - a.shape[1])) if a.shape[1] < n_nodes else a
    feat, thr_bin, internal, left, right, value = (torch.cat([pad(pt[k]) for pt in parts]) for k in range(6))
    tree = ttrees.Tree(feat=feat.long().cpu(), thr=ttrees.edges_lookup(edges, feat, thr_bin).float().cpu(),
                       internal=internal.cpu(), left=left.long().cpu(), right=right.long().cpu(),
                       value=value.cpu(), var_gain=torch.zeros((feat.shape[0], x.shape[1])))
    wts = torch.rand((feat.shape[0], 2), generator=torch.Generator().manual_seed(6))
    return tree, wts


def phase_kernel_k3(captured: dict):
    """K3 against its plain version on one full-width 256-row panel of the
    grid, with the merged forest that mltps_b built (every tree tabled) and
    with K2-grown trees of 6 and 9 splits (the 9-split trees in the slot
    loop of the same launch); the bound from the path work these cells
    need; S_MAX's measurement (6-split trees tabled against slot-tested)."""
    import torch

    from machisplin_tpu_torch.ops import forest

    t0 = time.perf_counter()
    ft, trees, tables = captured["forest"], captured["forest_trees"], captured["leaf_tables"]
    r0, x = k3_panel(captured["stack"])
    main = _k3_check(ft, x)
    ms = cuda_ms(lambda: forest.forest_predict_cuda(ft, x), reps=5)
    plain_ms = cuda_ms(lambda: forest.forest_predict_plain(ft, x), reps=1)
    m, p = x.shape
    slots, n_resp = ft.wv.shape
    # the bound: the work the function needs for these cells (path compares
    # and nonzero adds); bytes: the cells' features and the output once, each
    # real slot's bounds and values once
    compares, adds = _k3_path_work(trees, tables, ft, x)
    # the host's share of forest_tables_b that the outcome tables add
    t1 = time.perf_counter()
    forest.outcome_tables(type(trees)(*(a.cpu() for a in trees)), tables)
    outcome_s = time.perf_counter() - t1
    n_bins = int(torch.isfinite(ft.etab).sum(1).max()) + 1
    real = (ft.lo <= ft.hi).all(0)
    real_slots = int(real.sum())
    n_words = -(-p // 4)
    nbytes = 4 * m * (p + n_resp) + real_slots * (n_words * 8 + 4 * n_resp)
    ops = compares + adds
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    # PR 5's count, kept for the history in PERF.md: one compare per cell for
    # each bound a real slot constrains, R adds for each slot a cell falls in
    bounds = int(((ft.lo[:, real] > 0).sum() + (ft.hi[:, real] < n_bins - 1).sum()))
    slot_ops = m * bounds + n_resp * main["matches"]

    # a forest with trees above S_MAX: both loops in one launch
    grown, wts = _k3_grown_forest([6, 9])
    gtab = forest.build_leaf_bins(grown, n_feat=p)
    gft = forest.prepare_forest(grown, wts, gtab, "cuda")
    mixed = _k3_check(gft, x)
    mixed["trees"] = int(grown.feat.shape[0])
    mixed["ms"] = cuda_ms(lambda: forest.forest_predict_cuda(gft, x), reps=5)
    # S_MAX: the 6-split trees alone, tabled (s_max 6) or slot-tested (s_max 5)
    n6 = mixed["trees"] // 2
    six = type(grown)(*(a[:n6] for a in grown))
    six_tab = forest.build_leaf_bins(six, n_feat=p)
    s_max_ms = {}
    for s_max in (5, 6):
        sft = forest.prepare_forest(six, wts[:n6], six_tab, "cuda", s_max=s_max)
        s_max_ms[f"s_max_{s_max}"] = {"trees_tabled": int(sft.desc.shape[0]),
                                      "ms": cuda_ms(lambda: forest.forest_predict_cuda(sft, x), reps=5)}
    rf_res = _k3_rf_forest(x)
    res = {
        "phase": "kernel_k3", "seconds": time.perf_counter() - t0, "panel_rows": [r0, r0 + 256],
        "cells": m, "features": p, "slots": slots, "real_slots": real_slots, "responses": n_resp,
        "trees": int(trees.feat.shape[0]), **{k: v for k, v in main.items() if k != "agrees"},
        "tol": K3_TOL, "ms": ms, "plain_ms": plain_ms,
        "path_compares": compares, "adds": adds, "ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "slot_count": {"constrained_bounds": bounds, "ops": slot_ops, "bound_ms": slot_ops / PEAK_F32_OPS * 1e3},
        "mixed_forest": mixed, "six_split_trees": s_max_ms, "outcome_tables_host_s": outcome_s,
        "rf_forest": rf_res, "ptxas": _ptxas_summary("forest_predict"),
    }
    emit(res)
    failures = [f"K3 disagrees with its plain version on the {name} forest: counts equal "
                f"{r['membership_counts_equal']}, err {r['max_abs_err']} > {K3_TOL} * {r['sum_abs_wv']}"
                for name, r in (("main path's", main), ("mixed", mixed), ("random", rf_res)) if not r["agrees"]]
    if not mixed["trees_tabled"] or not mixed["loop_slots"]:
        failures.append(f"the mixed forest did not run both loops: {mixed['trees_tabled']} trees tabled, "
                        f"{mixed['loop_slots']} loop slots")
    if not res["bound_ms"] <= ms:
        failures.append(f"K3's bound {res['bound_ms']} ms lies above its time {ms} ms")
    if rf_res["trees_tabled"] or not rf_res["loop_slots"] or not rf_res["bound_ms"] <= rf_res["ms"]:
        failures.append(f"the random forest did not run in the slot loop alone, or its bound lies above its "
                        f"time: {rf_res['trees_tabled']} trees tabled, {rf_res['bound_ms']} > {rf_res['ms']} ms")
    if failures:
        raise RuntimeError("; ".join(failures))
    res["max_abs_err"] = max(main["max_abs_err"])
    return res


def _k3_rf_forest(x) -> dict:
    """K3 on the random forest the RF finals would build: 2 responses x the
    default 500 trees a response (MLTPSConfig().final_rf, max depth 9)
    grown on the stations, merged with a (1000, 2) weight matrix of 1/500
    on each response's own trees, on the panel's cells ``x``; with the
    bound counted as for the BRT forest (path compares and adds)."""
    import torch

    from machisplin_tpu_torch.models import rf, trees as ttrees
    from machisplin_tpu_torch.ops import forest
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    x_np, ys = _stations()
    t0 = time.perf_counter()
    st = rf.fit(torch.as_tensor(x_np, device="cuda"), torch.as_tensor(ys.T.copy(), dtype=torch.float32, device="cuda"),
                generator=torch.Generator().manual_seed(11), **MLTPSConfig().final_rf)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    n_resp, ntree = st.trees.feat.shape[:2]
    host = ttrees.Tree(*(a.reshape((n_resp * ntree,) + a.shape[2:]).cpu() for a in st.trees))
    wmat = torch.kron(torch.eye(n_resp), torch.full((ntree, 1), 1.0 / ntree))
    t1 = time.perf_counter()
    tables = forest.build_leaf_bins(host, n_feat=x.shape[1])
    ft = forest.prepare_forest(host, wmat, tables, "cuda")
    tables_s = time.perf_counter() - t1
    res = _k3_check(ft, x)
    res["ms"] = cuda_ms(lambda: forest.forest_predict_cuda(ft, x), reps=3)
    res["plain_ms"] = cuda_ms(lambda: forest.forest_predict_plain(ft, x), reps=1)
    compares, adds = _k3_path_work(host, tables, ft, x, levels=st.max_depth)
    m, p = x.shape
    real_slots = int((ft.lo <= ft.hi).all(0).sum())
    nbytes = 4 * m * (p + n_resp) + real_slots * (-(-p // 4) * 8 + 4 * n_resp)
    t_ops, t_bytes = (compares + adds) / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    res.update({
        "trees": n_resp * ntree, "max_depth": st.max_depth, "splits_max": int(host.internal.sum(1).max()),
        "splits_mean": float(host.internal.sum(1).float().mean()), "fit_s": fit_s, "tables_s": tables_s,
        "path_compares": compares, "adds": adds, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    })
    return res


def nn_cv_inputs(stations, dtype: str, device: str):
    """The NN letter's CV inputs at the main path's shape from ``stations``
    (``_stations()``): the covariates, the 20 (response x fold) lanes'
    [0, 1] responses and train masks (folds from numpy_folds(n, 10, 2,
    seed=0)), seeded inits, the lanes' de-scaling and the responses' range."""
    import torch

    from machisplin_tpu_torch.ensemble.cv import _nn_y_transform
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import nn

    x_np, ys = stations
    n, p = x_np.shape
    dt = getattr(torch, dtype)
    x = torch.as_tensor(x_np, dtype=dt, device=device)
    folds = torch.as_tensor(numpy_folds(n, 10, 2, seed=0), device=device)
    w = (folds[:, None, :] != torch.arange(10, device=device)[None, :, None]).to(dt).reshape(20, n)
    y = torch.as_tensor(ys.T, dtype=dt, device=device).repeat_interleave(10, dim=0)
    yn, y_min, y_max = _nn_y_transform(y, w)
    init = nn.draw_init(20, p, 10, generator=torch.Generator().manual_seed(8), dtype=dt, device=device)
    return x, yn, w, init, y_min, y_max, float(ys.max() - ys.min())


def _cuda_kernels(prof):
    """Kernels a profile saw on the card: (count, their summed time, the span
    from the first one's start to the last one's end), in µs."""
    import torch

    ks = [e.time_range for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.name.startswith(("Memcpy", "Memset"))]
    if not ks:
        return 0, 0.0, 0.0
    return len(ks), float(sum(k.elapsed_us() for k in ks)), float(max(k.end for k in ks) - min(k.start for k in ks))


def phase_nn_lbfgs():
    """The NN letter's L-BFGS at the CV shape: card against CPU in float64,
    then float32 steps timed, with kernel launches from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from machisplin_tpu_torch.models import nn

    t0 = time.perf_counter()
    stations = _stations()
    preds, stats = {}, {}
    for dev in ("cuda", "cpu"):
        x, yn, w, init, y_min, y_max, resp_range = nn_cv_inputs(stations, "float64", dev)
        stats[dev] = {}
        t1 = time.perf_counter()
        carry = nn.fit_carry_init(x, yn, sample_weight=w, hidden=10, init=init)
        for steps in (NN_STEPS_EARLY, NN_STEPS_CHECK - NN_STEPS_EARLY):
            carry = nn.fit_carry_steps(carry, x, yn, sample_weight=w, steps=steps, stats=stats[dev])
            pred = nn.predict(nn.carry_to_state(carry), x) * y_max[:, None] + y_min[:, None]
            preds[dev, steps] = pred.cpu()
        stats[dev]["seconds"] = time.perf_counter() - t1
    err_early = float((preds["cuda", NN_STEPS_EARLY] - preds["cpu", NN_STEPS_EARLY]).abs().max())
    err = float((preds["cuda", NN_STEPS_CHECK - NN_STEPS_EARLY] - preds["cpu", NN_STEPS_CHECK - NN_STEPS_EARLY])
                .abs().max())

    x, yn, w, init, _, _, _ = nn_cv_inputs(stations, "float32", "cuda")
    carry = nn.fit_carry_init(x, yn, sample_weight=w, hidden=10, init=init)
    carry = nn.fit_carry_steps(carry, x, yn, sample_weight=w, steps=10)     # warm-up
    timed = {}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nn.fit_carry_steps(carry, x, yn, sample_weight=w, steps=NN_STEPS_TIMED, stats=timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    lane_steps = timed["steps"]
    ms_step = (wall - timed["capture_s"]) * 1e3 / NN_STEPS_TIMED
    # kernel launches: 20 steps eager, 100 through the graph (whose count
    # includes the one eager warm-up pass of its capture)
    launches = {}
    for mode, graph, steps in (("eager", False, 20), ("graph", True, 100)):
        prof_stats = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            nn.fit_carry_steps(carry, x, yn, sample_weight=w, steps=steps, graph=graph, stats=prof_stats)
            torch.cuda.synchronize()
        k, busy_us, span_us = _cuda_kernels(prof)
        launches[mode] = {"steps": steps, "kernels": k, "passes": prof_stats["passes"], "kernels_per_step": k / steps,
                          "kernels_per_pass": k / max(prof_stats["passes"], 1),
                          "kernel_us_mean": busy_us / max(k, 1),
                          "device_busy_share": busy_us / span_us if span_us else None}
    res = {
        "phase": "nn_lbfgs", "seconds": time.perf_counter() - t0, "lanes": 20, "stations": int(x.shape[0]),
        "features": int(x.shape[1]), "hidden": 10, "check_steps": NN_STEPS_CHECK, "check_stats": stats,
        "max_abs_err": err, "response_range": resp_range, "tol": NN_TOL * resp_range,
        "early_steps": NN_STEPS_EARLY, "max_abs_err_early": err_early, "tol_early": NN_TOL_EARLY * resp_range,
        "timed_steps": NN_STEPS_TIMED, "dtype_timed": "float32", "wall_s": wall, "capture_s": timed["capture_s"],
        "ms_per_step": ms_step, "passes_per_step": timed["passes"] / NN_STEPS_TIMED,
        "ms_per_pass": (wall - timed["capture_s"]) * 1e3 / timed["passes"],
        "evaluations_per_lane_step": timed["evaluations"] / lane_steps,
        "syncs_per_step": timed["syncs"] / NN_STEPS_TIMED, "launches": launches,
    }
    emit(res)
    if not err_early <= NN_TOL_EARLY * resp_range:
        raise RuntimeError(f"the NN's L-BFGS on the card parts from the CPU's after {NN_STEPS_EARLY} steps: "
                           f"{err_early} > {NN_TOL_EARLY} * {resp_range}")
    if not err <= NN_TOL * resp_range:
        raise RuntimeError(f"the NN's L-BFGS on the card parts from the CPU's: {err} > {NN_TOL} * {resp_range}")
    return res


def _bn_band(name: str, key: str, ref=None):
    """(mean, tolerance) of the JAX package's values of ``key`` over its keys."""
    vals = (ref or JAX_REFERENCE_BN)[name][key]
    spread = max(vals) - min(vals)
    return sum(vals) / len(vals), max(R2_TOL_B, 3 * spread)


def phase_mltps_bn():
    """The pool the reference keeps: mltps over BRT + NN at full size, float32."""
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    t_setup = time.perf_counter() - t0

    timer = mtt.PhaseTimer()
    _reset_launches()
    t1 = time.perf_counter()
    out = mtt.mltps(s, cov, tps=True, config=MLTPSConfig(letters_pool="bn"), folds=folds,
                    generator=torch.Generator().manual_seed(0), device="cuda", timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _read_launches()

    mask = torch.isfinite(cov.data).all(0)
    layers, failures = {}, []
    for r in out:
        for attr in ("final", "ensemble", "tps_surface"):
            d = getattr(r, attr).data
            if tuple(d.shape) != cov.grid.shape or not torch.isfinite(d[mask]).all():
                failures.append(f"{r.name}.{attr} is not finite over the covariate mask")
        got = {"kept": r.summary["best model(s):"], "percent": r.summary["ensemble weights:"],
               "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"]}
        layers[r.name] = got
        kept_jax = set(JAX_REFERENCE_BN[r.name]["kept"])
        if len(kept_jax) == 1 and got["kept"] not in kept_jax:
            failures.append(f"{r.name} kept {got['kept']!r}, every JAX key keeps {kept_jax.pop()!r}")
        for key in ("r2_ensemble", "r2_final"):
            mean, tol = _bn_band(r.name, key)
            got[key + "_band"] = [mean, tol]
            if not abs(got[key] - mean) <= tol:
                failures.append(f"{r.name} {key} {got[key]} vs the JAX package's {mean} +- {tol}")
    phases = timer.as_dict()
    emit({
        "phase": "mltps_bn", "seconds": time.perf_counter() - t0, "setup_s": t_setup, "mltps_wall_s": wall,
        "grid": list(cov.grid.shape), "stations": n, "dtype": str(cov.data.dtype), "phases_s": phases,
        "cv_letter_s": {k[3:]: v for k, v in phases.items() if k.startswith("cv_") and len(k) == 4},
        "launches": launches, "layers": layers, "jax_reference": JAX_REFERENCE_BN,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if launches["tps_grid"] != 6:
        failures.append(f"K1 launched {launches['tps_grid']} times on the BRT + NN path, expected 6")
    if launches["tree_grow"] <= 0 or launches["forest_predict"] <= 0:
        failures.append(f"a tree kernel did not run on the BRT + NN path: {launches}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return launches


def svm_cv_inputs(dtype: str):
    """K4's operands at the CV shape, as the SVM letter builds them on the
    card (``models/svm.sweep_inputs``): the stations' covariates, 20
    (response x fold) lanes with folds from numpy_folds(n, 10, 2, seed=0)
    and seeded sigest pairs.  Returns (q, ys, w, diag)."""
    import torch

    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import svm

    x_np, ys = _stations()
    n, p = x_np.shape
    dt = getattr(torch, dtype)
    x = torch.as_tensor(x_np, dtype=dt, device="cuda")
    folds = torch.as_tensor(numpy_folds(n, 10, 2, seed=0), device="cuda")
    w = (folds[:, None, :] != torch.arange(10, device="cuda")[None, :, None]).to(dt).reshape(20, n)
    y = torch.as_tensor(ys.T.copy(), dtype=dt, device="cuda").repeat_interleave(10, dim=0)
    pairs = tuple(a.cuda() for a in svm.draw_sigest_pairs(20, n, torch.Generator().manual_seed(9)))
    _, ysn, q, diag = svm.sweep_inputs(x.expand(20, n, p), y, w, pairs)
    return q, ysn, w.contiguous(), diag


def svm_inputs(shape: str, dtype: str):
    """K4's operands and sweep count at one of SVM_SHAPES: "cv" as
    ``svm_cv_inputs``; "finals" the stations with both responses and every
    row weighted 1 (the SVM finals' two lanes); "many" 4096 stations made
    from numpy's default_rng(4096) (p = 5, two smooth responses with noise)
    in 20 CV lanes (folds from numpy_folds(4096, 10, 2, seed=0)).  Returns
    (q, ys, w, diag, epochs)."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import svm

    lanes, n, epochs = SVM_SHAPES[shape]
    if shape == "cv":
        return (*svm_cv_inputs(dtype), epochs)
    dt = getattr(torch, dtype)
    if shape == "finals":
        x_np, ys = _stations()
        y = torch.as_tensor(ys.T.copy(), dtype=dt, device="cuda")
        w = torch.ones((lanes, n), dtype=dt, device="cuda")
    else:
        rng = np.random.default_rng(n)
        x_np = rng.normal(size=(n, 5)) * np.array([1.0, 30.0, 2.0, 5.0, 0.5])
        resp = np.stack([np.sin(x_np[:, 0]) + 0.02 * x_np[:, 1], np.cos(x_np[:, 2]) - 0.1 * x_np[:, 3]])
        resp = resp + 0.1 * rng.normal(size=resp.shape)
        folds = torch.as_tensor(numpy_folds(n, 10, 2, seed=0), device="cuda")
        w = (folds[:, None, :] != torch.arange(10, device="cuda")[None, :, None]).to(dt).reshape(lanes, n)
        y = torch.as_tensor(resp, dtype=dt, device="cuda").repeat_interleave(10, dim=0)
    x = torch.as_tensor(x_np, dtype=dt, device="cuda")
    pairs = tuple(a.cuda() for a in svm.draw_sigest_pairs(lanes, n, torch.Generator().manual_seed(9)))
    _, ysn, q, diag = svm.sweep_inputs(x.expand(lanes, n, x.shape[1]), y, w, pairs)
    return q, ysn, w.contiguous(), diag, epochs


def _event_ms(fn):
    """(fn's result, its CUDA-event ms), one run."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def _k4_sass_loop() -> dict:
    """Instructions a coordinate step in K4's chain loop (float32), from its
    SASS: ``tools/sass_loop.py k4``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("sass_loop", os.path.join("tools", "sass_loop.py"))
    sl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sl)
    name, instance, marker, per_step = sl.KERNELS["k4"]
    src = os.path.join("machisplin_tpu_torch", "csrc", f"{name}.cu")
    return sl.loop_counts(sl._sass(src, []), instance, marker, per_step, densest=True)


def phase_kernel_svm():
    """K4 against its plain version at SVM_SHAPES (the CV shape and the
    finals' in float32 and float64, 4096 stations in float32): theta and
    the multiplier within SVM_TOL of C; the first launch's and the warm
    CUDA-event times, ns a coordinate step, the bound, ptxas's registers
    and spills and the chain loop's instructions a step from the SASS."""
    import torch

    from machisplin_tpu_torch.ops import svm_sweep

    t0 = time.perf_counter()
    per, failures = {}, []
    for shape, dtype in SVM_RUNS:
        q, ys, w, diag, epochs = svm_inputs(shape, dtype)
        lanes, n = ys.shape
        (theta, lam), first_ms = _event_ms(lambda: svm_sweep.svm_sweep_cuda(q, ys, w, diag, epochs=epochs))
        (ptheta, plam), plain_ms = _event_ms(lambda: svm_sweep.svm_sweep_plain(q, ys, w, diag, epochs=epochs))
        err = max(float((theta - ptheta).abs().max()), float((lam - plam).abs().max()))
        ms = cuda_ms(lambda: svm_sweep.svm_sweep_cuda(q, ys, w, diag, epochs=epochs), reps=3)
        size = q.element_size()
        # each input read once (q, ys, w, diag), each output written once (theta, lam);
        # a coordinate step: the row's n multiply-adds and ~15 scalar operations
        nbytes = size * (lanes * n * n + 4 * lanes * n + lanes)
        ops = lanes * epochs * n * (2 * n + 15)
        peak = PEAK_F32_OPS if dtype == "float32" else PEAK_F64_OPS
        t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        key = f"{shape}_{dtype}"
        per[key] = {
            "lanes": lanes, "stations": n, "epochs": epochs, "max_abs_err": err, "tol": SVM_TOL[dtype],
            "finite": bool(torch.isfinite(theta).all() and torch.isfinite(lam).all()),
            "support_vectors_mean": float((theta.abs() > 1e-6).sum(1).float().mean()),
            "ms": ms, "first_launch_ms": first_ms, "ns_per_step": ms * 1e6 / (epochs * n),
            "plain_ms": plain_ms, "ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        if not (per[key]["finite"] and err <= SVM_TOL[dtype]):
            failures.append(f"K4 disagrees with its plain version at {key}: {err} > {SVM_TOL[dtype]}")
        del q, ys, w, diag, theta, ptheta
    res = {"phase": "kernel_svm", "seconds": time.perf_counter() - t0, **per,
           "ptxas": _ptxas_summary("svm_sweep"), "sass_chain_loop": _k4_sass_loop()}
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return per["cv_float32"]


def phase_mltps_main(keep: dict | None = None):
    """The north-star call: mltps with the default pool at full size,
    float32.  ``keep`` receives its folds, CV residuals and layers, which
    ``mesh_main`` holds the mesh's run to."""
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    t_setup = time.perf_counter() - t0

    timer = mtt.PhaseTimer()
    cv_res: dict = {}
    restore = _record_cv(cv_res)
    _reset_launches()
    t1 = time.perf_counter()
    try:
        out = mtt.mltps(s, cov, tps=True, folds=folds, generator=torch.Generator().manual_seed(0), device="cuda",
                        timer=timer)
    finally:
        restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _read_launches()
    if keep is not None:
        keep.update(folds=folds, cv=cv_res, layers=_layer_arrays(out), wall_s=wall)

    mask = torch.isfinite(cov.data).all(0)
    layers, failures = {}, []
    for r in out:
        for attr in ("final", "ensemble", "tps_surface"):
            d = getattr(r, attr).data
            if tuple(d.shape) != cov.grid.shape or not torch.isfinite(d[mask]).all():
                failures.append(f"{r.name}.{attr} is not finite over the covariate mask")
        got = {"kept": r.summary["best model(s):"], "percent": r.summary["ensemble weights:"],
               "weights": [float(v) for v in r.weights.weights],
               "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"]}
        layers[r.name] = got
        kept_jax = set(JAX_REFERENCE_MAIN[r.name]["kept"])
        if got["kept"] not in kept_jax:
            failures.append(f"{r.name} kept {got['kept']!r}, the JAX keys keep {sorted(kept_jax)}")
        for key in ("r2_ensemble", "r2_final"):
            mean, tol = _bn_band(r.name, key, JAX_REFERENCE_MAIN)
            got[key + "_band"] = [mean, tol]
            if not abs(got[key] - mean) <= tol:
                failures.append(f"{r.name} {key} {got[key]} vs the JAX package's {mean} +- {tol}")
    phases = timer.as_dict()
    emit({
        "phase": "mltps_main", "seconds": time.perf_counter() - t0, "setup_s": t_setup, "mltps_wall_s": wall,
        "grid": list(cov.grid.shape), "stations": n, "dtype": str(cov.data.dtype), "phases_s": phases,
        "cv_letter_s": {k[3:]: v for k, v in phases.items() if k.startswith("cv_") and len(k) == 4},
        "launches": launches, "layers": layers, "jax_reference": JAX_REFERENCE_MAIN,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if launches["tps_grid"] != 6:
        failures.append(f"K1 launched {launches['tps_grid']} times on the main path, expected 6")
    for name in ("tree_grow", "forest_predict", "svm_sweep"):
        if launches[name] <= 0:
            failures.append(f"kernel {name} did not run on the main path: {launches}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return launches


def phase_mltps_one():
    """The single-response north-star call: mltps over bio_1 alone with the
    default pool at full size, float32; a kept BRT takes the serial gbm.step
    (``gbm_step.fit``) for its final fit."""
    import numpy as np
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import gbm_step
    from machisplin_tpu_torch.ops import tree_grow

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    s = mtt.load_sampling()
    one = np.rec.fromarrays([s["long"], s["lat"], s["bio_1"]], names="long,lat,bio_1")
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 1, seed=0)
    t_setup = time.perf_counter() - t0

    # observe (without changing) the serial final: its K2 launches and result
    serial = gbm_step.fit
    seen = {}

    def fit_seen(*a, **kw):
        before = dict(tree_grow.LAUNCHES)
        res = serial(*a, **kw)
        torch.cuda.synchronize()
        seen["k2"] = {k: tree_grow.LAUNCHES[k] - before[k] for k in before}
        seen["final"] = {"best_trees": res.best_trees, "trees_fitted": res.trees_fitted, "restarts": res.restarts,
                         "learning_rate": res.learning_rate, "cv_deviance_min": float(res.cv_deviance.min())}
        return res

    gbm_step.fit = fit_seen
    timer = mtt.PhaseTimer()
    try:
        _reset_launches()
        t1 = time.perf_counter()
        out = mtt.mltps(one, cov, tps=True, folds=folds, generator=torch.Generator().manual_seed(0), device="cuda",
                        timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = _read_launches()
    finally:
        gbm_step.fit = serial

    mask = torch.isfinite(cov.data).all(0)
    layers, failures = {}, []
    for r in out:
        for attr in ("final", "ensemble", "tps_surface"):
            d = getattr(r, attr).data
            if tuple(d.shape) != cov.grid.shape or not torch.isfinite(d[mask]).all():
                failures.append(f"{r.name}.{attr} is not finite over the covariate mask")
        got = {"kept": r.summary["best model(s):"], "percent": r.summary["ensemble weights:"],
               "weights": [float(v) for v in r.weights.weights],
               "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"]}
        layers[r.name] = got
        kept_jax = set(JAX_REFERENCE_ONE[r.name]["kept"])
        if got["kept"] not in kept_jax:
            failures.append(f"{r.name} kept {got['kept']!r}, the JAX keys keep {sorted(kept_jax)}")
        for key in ("r2_ensemble", "r2_final"):
            mean, tol = _bn_band(r.name, key, JAX_REFERENCE_ONE)
            got[key + "_band"] = [mean, tol]
            if not abs(got[key] - mean) <= tol:
                failures.append(f"{r.name} {key} {got[key]} vs the JAX package's {mean} +- {tol}")
    phases = timer.as_dict()
    emit({
        "phase": "mltps_one", "seconds": time.perf_counter() - t0, "setup_s": t_setup, "mltps_wall_s": wall,
        "grid": list(cov.grid.shape), "stations": n, "dtype": str(cov.data.dtype), "phases_s": phases,
        "cv_letter_s": {k[3:]: v for k, v in phases.items() if k.startswith("cv_") and len(k) == 4},
        "launches": launches, "serial_final_k2": seen.get("k2"), "serial_final": seen.get("final"),
        "layers": layers, "jax_reference": JAX_REFERENCE_ONE, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if [r.name for r in out] != ["bio_1"]:
        failures.append(f"mltps_one returned {[r.name for r in out]}")
    if launches["tps_grid"] != 6:
        failures.append(f"K1 launched {launches['tps_grid']} times on the single-response path, expected 6")
    for name in ("tree_grow", "forest_predict", "svm_sweep"):
        if launches[name] <= 0:
            failures.append(f"kernel {name} did not run on the single-response path: {launches}")
    if "b" in layers["bio_1"]["kept"] and not (seen.get("k2") or {}).get("tree_grow", 0) > 0:
        failures.append(f"the serial gbm.step final did not launch K2: {seen.get('k2')}")
    if failures:
        raise RuntimeError("; ".join(failures))
    return launches


def _same_bits(a, b) -> bool:
    """Two float32 rasters (or None) equal bit for bit, NaN included, on one grid."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    return (a.data.dtype == b.data.dtype == torch.float32 and vars(a.grid) == vars(b.grid)
            and a.data.device == b.data.device and torch.equal(a.data.view(torch.int32), b.data.view(torch.int32)))


def phase_tiles_main(keep: dict):
    """README Example 2 on the full grid: tiles_create, the north-star call
    on every tile, the writers, every GeoTIFF read back onto the card bit for
    bit, and tiles_merge of the read-back finals on the card against the
    same merge on the CPU."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    s = mtt.load_sampling()
    ts = mtt.tiles_create(cov, s, **TILES)
    failures = []
    layout = {"extents": [list(e) for e in ts.extents], "stations": [len(d) for d in ts.dat],
              "shapes": [list(r.grid.shape) for r in ts.rast]}
    if layout != JAX_TILES_LAYOUT:
        failures.append(f"tiles_create's layout {layout} is not the JAX package's {JAX_TILES_LAYOUT}")
    out_dir = tempfile.mkdtemp(prefix="tiles_main_")
    tiles, finals, results = [], {}, []
    native: dict = {}
    try:
        for t, (rast, dat) in enumerate(zip(ts.rast, ts.dat)):
            n = int(torch.isfinite(mtt.extract(rast, dat["long"], dat["lat"])).all(1).sum())
            folds = numpy_folds(n, 10, 2, seed=t)
            timer = mtt.PhaseTimer()
            _reset_launches()
            t1 = time.perf_counter()
            out = mtt.mltps(dat, rast, tps=True, folds=folds, generator=torch.Generator().manual_seed(t),
                            device="cuda", timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = _read_launches()
            t2 = time.perf_counter()
            d = os.path.join(out_dir, f"tile_{t + 1}")
            paths = mtt.write_geotiff(out, d, seed=t) + mtt.write_residuals(out, d) + mtt.write_loadings(out, d)
            t_write = time.perf_counter() - t2
            mask = torch.isfinite(rast.data).all(0)
            ref = JAX_REFERENCE_TILES[t] if JAX_REFERENCE_TILES else None
            layers = {}
            for r in out:
                back = mtt.read_geotiff(os.path.join(d, f"{r.name}.tif"), device="cuda")
                same = _same_bits(back, r.final)
                if not native:
                    native = _native_read_check(os.path.join(d, f"{r.name}.tif"), back)
                    if native["zlib_h"] and not native["bit_identical"]:      # else no library: said above
                        failures.append(f"the native decoder's read of {r.name}.tif is not the Python codec's")
                if not same:
                    failures.append(f"tile {t + 1} {r.name}: the GeoTIFF read back is not the final bit for bit")
                if not torch.isfinite(r.final.data[mask]).all():
                    failures.append(f"tile {t + 1} {r.name}: final not finite over the covariate mask")
                finals.setdefault(r.name, []).append(back)
                got = {"kept": r.summary["best model(s):"], "percent": r.summary["ensemble weights:"],
                       "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"],
                       "geotiff_bit_identical": same}
                layers[r.name] = got
                if ref is None:
                    failures.append("no JAX reference recorded for the tiles")
                    continue
                kept_jax = set(ref[r.name]["kept"])
                if len(kept_jax) == 1 and got["kept"] not in kept_jax:
                    failures.append(f"tile {t + 1} {r.name} kept {got['kept']!r}, every JAX key keeps {kept_jax}")
                for key in ("r2_ensemble", "r2_final"):
                    mean, tol = _bn_band(r.name, key, ref)
                    got[key + "_band"] = [mean, tol]
                    if not abs(got[key] - mean) <= tol:
                        failures.append(f"tile {t + 1} {r.name} {key} {got[key]} vs the JAX package's {mean} +- {tol}")
            tiles.append({"tile": t + 1, "grid": list(rast.grid.shape), "stations": n, "mltps_wall_s": wall,
                          "write_s": t_write, "files": len(paths), "phases_s": timer.as_dict(), "launches": launches,
                          "layers": layers})
            for name in ("tps_grid", "tree_grow", "svm_sweep"):
                if launches[name] <= 0:
                    failures.append(f"tile {t + 1}: kernel {name} did not run: {launches}")
            if any("b" in g["kept"] for g in layers.values()) and launches["forest_predict"] <= 0:
                failures.append(f"tile {t + 1} keeps b but K3 did not run: {launches}")
            if launches["tree_grow_trees"] != K2_CYCLE * launches["tree_grow"]:
                failures.append(f"tile {t + 1}: K2 did not grow {K2_CYCLE}-tree cycles: {launches}")
            results.append(out)
        # the read-back finals merged on the card, against the same merge on the CPU
        full_mask = torch.isfinite(cov.data).all(0)
        merge = {}
        _reset_launches()
        for name, tl in finals.items():
            t3 = time.perf_counter()
            got = mtt.tiles_merge(tl, ts.full_grid, in_ncol=TILES["out_ncol"], in_nrow=TILES["out_nrow"])
            torch.cuda.synchronize()
            t_merge = time.perf_counter() - t3
            want = mtt.tiles_merge([r.to("cpu") for r in tl], ts.full_grid, in_ncol=TILES["out_ncol"],
                                   in_nrow=TILES["out_nrow"])
            g_np, w_np = got.data.cpu().numpy(), want.data.numpy()
            scale = float(np.nanmax(np.abs(w_np)))
            same_nan = bool((np.isnan(g_np) == np.isnan(w_np)).all())
            err = float(np.nanmax(np.abs(g_np - w_np)))
            finite = bool(torch.isfinite(got.data[full_mask]).all())
            merge[name] = {"merge_s": t_merge, "device": str(got.data.device), "max_abs_err": err, "scale": scale,
                           "same_nan": same_nan, "finite_over_mask": finite, "grid": list(got.grid.shape)}
            if got.grid.shape != cov.grid.shape or got.data.device.type != "cuda":
                failures.append(f"{name}: merged {got.grid.shape} on {got.data.device}")
            if not (same_nan and err <= MERGE_TOL * scale):
                failures.append(f"{name}: the card's merge differs from the CPU's by {err} (NaN same {same_nan})")
            if not finite:
                failures.append(f"{name}: the merge is not finite wherever the covariates are")
        merge_launches = _read_launches()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    keep.update(tiles=ts, results=results)
    emit({"phase": "tiles_main", "seconds": time.perf_counter() - t0, "tiles_layout": TILES, "layout": layout,
          "tiles": tiles, "merge": merge, "merge_launches": merge_launches, "native_decoder": native,
          "jax_reference": JAX_REFERENCE_TILES, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if failures:
        raise RuntimeError("; ".join(failures))
    return tiles


def _zlib_header() -> bool:
    """Whether the C++ compiler finds zlib.h, which the host library's
    deflate branch needs; says so on a line of its own when it does not."""
    from machisplin_tpu_torch.kernels.build import host_finds_header

    ok = host_finds_header("zlib.h")
    if not ok:
        print("zlib.h: not found by the C++ compiler; the host library (csrc/host_native.cpp) cannot build "
              "its deflate decoder", flush=True)
    return ok


def _native_read_check(path: str, back) -> dict:
    """A GeoTIFF read through the host library's decoder (``back``, which
    must have taken it) against the pure-Python codec's read, bit for bit."""
    from machisplin_tpu_torch.io import native
    import machisplin_tpu_torch as mtt

    decoded = []
    decode, load = native.decode_chunks, native.load_native

    def counted(*a, **k):
        blob = decode(*a, **k)
        decoded.append(blob is not None)
        return blob

    native.decode_chunks = counted
    try:
        again = mtt.read_geotiff(path, device="cuda")
        native.load_native = lambda: None          # without the library: the pure-Python codec
        plain = mtt.read_geotiff(path, device="cuda")
    finally:
        native.decode_chunks, native.load_native = decode, load
    taken = decoded == [True, False]
    return {"file": os.path.basename(path), "zlib_h": _zlib_header(), "native_path_taken": taken,
            "bit_identical": taken and _same_bits(again, plain) and _same_bits(back, plain)}


def phase_resume_tile(keep: dict):
    """Checkpoint and resume on the first tile: its bio_1 result saved, then
    mltps_resumable over bio_1 and bio_12 with a run log: bio_1 loaded with
    no kernel launch and bit for bit, bio_12 computed on the card (one
    response: a kept BRT's final through the serial gbm.step)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.io import checkpoint
    from machisplin_tpu_torch.models import gbm_step
    from machisplin_tpu_torch.ops import tree_grow

    t0 = time.perf_counter()
    ts, saved = keep["tiles"], keep["results"][0][0]
    rast, dat = ts.rast[0], ts.dat[0]
    ck = tempfile.mkdtemp(prefix="resume_tile_")
    failures, seen = [], {}
    load, fit = checkpoint.load_layer, gbm_step.fit

    def load_seen(*a, **kw):
        before = _read_launches()
        res = load(*a, **kw)
        torch.cuda.synchronize()
        seen["load_launches"] = {k: v - before[k] for k, v in _read_launches().items()}
        return res

    def fit_seen(*a, **kw):
        before = dict(tree_grow.LAUNCHES)
        res = fit(*a, **kw)
        torch.cuda.synchronize()
        seen["serial_final_k2"] = {k: tree_grow.LAUNCHES[k] - before[k] for k in before}
        seen["serial_final"] = {"best_trees": res.best_trees, "restarts": res.restarts}
        return res

    try:
        checkpoint.save_layer(os.path.join(ck, f"{saved.name}.npz"), saved)
        n = int(torch.isfinite(mtt.extract(rast, dat["long"], dat["lat"])).all(1).sum())
        log_file = os.path.join(ck, "MachiSplin.LOG.txt")
        checkpoint.load_layer, gbm_step.fit = load_seen, fit_seen
        try:
            _reset_launches()
            t1 = time.perf_counter()
            out = checkpoint.mltps_resumable(dat, rast, ck, folds=numpy_folds(n, 10, 2, seed=0), tps=True,
                                             generator=torch.Generator().manual_seed(10), device="cuda",
                                             log_file=log_file)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = _read_launches()
        finally:
            checkpoint.load_layer, gbm_step.fit = load, fit
        log_bytes = os.path.getsize(log_file) if os.path.exists(log_file) else 0
        loaded, computed = out
        same = (loaded.name == saved.name and loaded.summary == saved.summary
                and np.array_equal(loaded.residuals, saved.residuals)
                and all(_same_bits(getattr(loaded, k), getattr(saved, k))
                        for k in ("final", "ensemble", "tps_surface")))
        mask = torch.isfinite(rast.data).all(0)
        finite = bool(torch.isfinite(computed.final.data[mask]).all())
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    load_launches = seen.get("load_launches")
    kept = computed.summary["best model(s):"]
    res = {"phase": "resume_tile", "seconds": time.perf_counter() - t0, "resumable_wall_s": wall,
           "loaded": loaded.name, "loaded_bit_identical": same, "load_launches": load_launches,
           "computed": computed.name, "computed_kept": kept, "computed_r2_ensemble": computed.summary["r2 ensemble:"],
           "computed_r2_final": computed.summary["r2 final:"], "finite": finite, "launches": launches,
           "serial_final_k2": seen.get("serial_final_k2"), "serial_final": seen.get("serial_final"),
           "log_bytes": log_bytes, "stations": n}
    emit(res)
    if (loaded.name, computed.name) != ("bio_1", "bio_12"):
        failures.append(f"mltps_resumable returned {loaded.name}, {computed.name}")
    if load_launches is None or any(load_launches.values()):
        failures.append(f"loading the checkpoint launched kernels: {load_launches}")
    if not same:
        failures.append("the loaded layer is not the saved one bit for bit")
    if not finite:
        failures.append("bio_12 is not finite over the covariate mask")
    for name in ("tps_grid", "tree_grow", "svm_sweep"):
        if launches[name] <= 0:
            failures.append(f"kernel {name} did not run computing bio_12: {launches}")
    if "b" in kept and not (seen.get("serial_final_k2") or {}).get("tree_grow", 0) > 0:
        failures.append(f"bio_12 keeps b but the serial gbm.step final did not launch K2: {seen}")
    if log_bytes <= 0:
        failures.append("mltps(log_file=...) wrote an empty log")
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def phase_cv_b_perfold():
    """The batched gbm.step's per-fold and shared bins at the CV shape (813
    stations x 2 responses, CVConfig.brt): fit_outer_batched as run_cv's
    letter b calls it, 20 outer chains of 10 inner chains, with the global
    table, 20 shared tables and 200 tables; fit_multi with both bins at the
    finals' shape; and one 50-tree cycle of the shared and per-fold table
    layouts against K2's plain version (trees part only at near-ties,
    TIE_GAP), with ms a tree beside the global table's."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.ensemble.cv import CVConfig
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.models import gbm_step, trees as ttrees
    from machisplin_tpu_torch.ops import tree_grow
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    t0 = time.perf_counter()
    x_np, ys = _stations()
    n, p = x_np.shape
    x = torch.as_tensor(x_np, device="cuda")
    ycols = torch.as_tensor(ys, dtype=torch.float32, device="cuda")
    folds = torch.as_tensor(numpy_folds(n, 10, 2, seed=0), device="cuda")
    outer = (folds[:, None, :] != torch.arange(10, device="cuda")[None, :, None]).float().reshape(20, n)
    y_outer = ycols.T.repeat_interleave(10, dim=0).contiguous()
    brt = CVConfig().brt
    failures = []
    runs = {}
    for name, kw in (("global", dict(global_bins=True)), ("shared", dict(global_bins=False, shared_bins=True)),
                     ("per_fold", dict(global_bins=False, shared_bins=False))):
        _reset_launches()
        t1 = time.perf_counter()
        pred, best = gbm_step.fit_outer_batched(x, y_outer, outer, generator=torch.Generator().manual_seed(0),
                                                **dict(brt, **kw))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {k: v for k, v in _read_launches().items() if k.startswith("tree_grow")}
        best = best.reshape(2, 10)
        runs[name] = {"seconds": wall, "launches": launches, "finite": bool(torch.isfinite(pred).all()),
                      "best_trees_per_response": {"bio_1": best[0].tolist(), "bio_12": best[1].tolist()}}
        if not runs[name]["finite"] or launches["tree_grow"] <= 0:
            failures.append(f"fit_outer_batched {name}: finite {runs[name]['finite']}, launches {launches}")
    final_brt = MLTPSConfig().final_brt
    multi = {}
    for name, shared in (("shared", True), ("per_fold", False)):
        _reset_launches()
        t1 = time.perf_counter()
        res = gbm_step.fit_multi(x, ycols, global_bins=False, shared_bins=shared,
                                 generator=torch.Generator().manual_seed(0), **final_brt)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _read_launches().items() if k.startswith("tree_grow")}
        multi[name] = {"seconds": time.perf_counter() - t1, "launches": launches,
                       "best_trees": [r.best_trees for r in res], "restarts": [r.restarts for r in res],
                       "finite": all(bool(torch.isfinite(r.final.train_fit).all()) for r in res)}
        if not multi[name]["finite"] or launches["tree_grow"] <= 0:
            failures.append(f"fit_multi {name}: {multi[name]}")

    # one cycle of each table layout at the CV shape, against the plain version
    nb, min_leaf = brt.get("n_bins", 64), brt.get("min_leaf", 10.0)
    sel = gbm_step._draw_selectors(torch.Generator().manual_seed(1), outer, 10)
    w = (sel[:, None, :] != torch.arange(10, device="cuda")[None, :, None]).float() * outer[:, None, :]
    w = w.reshape(200, n)
    y = y_outer.repeat_interleave(10, dim=0).contiguous()
    f = ((w * y).sum(1) / w.sum(1).clamp_min(1.0))[:, None].expand(200, n).contiguous()
    g = torch.Generator(device="cuda").manual_seed(4)
    bags = (torch.rand((K2_CYCLE, 200, n), generator=g, device="cuda") < brt["bag_fraction"]).float() * w
    kw = dict(n_splits=brt["tree_complexity"], nb=nb, min_leaf=min_leaf, lr=brt["learning_rate"])
    cycles = {}
    for name, (wt, rep, n_tables) in {"global": (None, 1, 1), "shared": (outer, 10, 20),
                                       "per_fold": (w, 1, 200)}.items():
        edges, xb, tables = gbm_step._grow_inputs(x, nb, wt, repeat=rep)
        xb_c = xb.repeat_interleave(rep, 0) if rep > 1 else xb
        plain = tables._replace(cum1h=ttrees.flat_bin_cum_onehot(xb_c, nb))
        grown, timed = _k2_timed(tables, y, f, bags, kw, xb_c.cpu().numpy(), plain, n_tables=n_tables)
        agree = tree_grow.cycle_agreement(xb_c, y, f, bags, grown, cum1h=plain.cum1h, **kw)
        if name == "global":
            # the time to compare with; kernel_k2 holds the global table's
            # cycle at this shape.  With these draws one chain's tree parts
            # at a 1.31e-4 gain gap (chain 13, tree 41; NVIDIA H100 80GB
            # HBM3, 700.00 W): bio_12's deep nodes at float32's resolution,
            # as at the ceiling shapes (CEILING_TIE_GAP)
            check = dict(agree, gaps=sorted(g[2] for g in agree["gaps"]))
        else:
            check = _k2_agree_check(f"{name} bins", agree, failures)
        cycles[name] = {"tables": n_tables, "chains": 200, **timed, "plain_cycle_check": check}
    out = {"phase": "cv_b_perfold", "seconds": time.perf_counter() - t0, "stations": n, "features": p,
           "brt": brt, "fit_outer_batched": runs, "fit_multi_finals_shape": multi, "cycle": cycles,
           "ms_per_tree_vs_global": {k: v["ms"] / cycles["global"]["ms"] for k, v in cycles.items()}}
    emit(out)
    if failures:
        raise RuntimeError("; ".join(failures))
    return out


# The large-station TPS path (BASELINE configs 3-5).  The JAX package's fits
# at numpy-drawn landmarks come from
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_nystrom.py > tools/record_jax_nystrom.json`
# (float32, as the configs' coordinates).  Stated before the first card run:
# lambda on the same point of the 128-point GCV grid or the next one
# (float32 cross-products summed in another order can move a near-tie);
# GCV and effective df within NYS_REL; fitted values within NYS_FIT_TOL and
# surface cells within NYS_SURF_TOL of the response range.
NYS_LAM_DECADES = 16.0 / 127.0 + 1e-6
NYS_REL = 1e-2
NYS_FIT_TOL = 1e-3
NYS_SURF_TOL = 2e-3
# the host float64 fit against the JAX package's (float32 outputs) and the
# card's exact float64 fit of the same 3,000 stations
HOST_LAM_RTOL = 1e-5
HOST_DEV_LAM_RTOL = 1e-4
HOST_DEV_FIT_TOL = 1e-6
SIGNAL_R2_MIN = 0.99   # fitted values against the noise-free signal
CONFIG4 = {"panel_rows": 1536, "side": 10_000, "landmarks": 4096}
CONFIG3 = {"side": 3163, "landmarks": 2048, "exact": 8192, "host": 3000, "host_limit": 2048}
CONFIG5 = {"stations": 500_000, "side": 31_623, "band_rows": 2048, "landmarks": 4096}
NYS_CHUNK = 16384      # the recorder's chunk

# The JAX package's mltps with the extension options (EXT_CONFIG: smooth GAM,
# MARS degree 2 with penalty 3, the sweep weight search, the tile loop) on
# the full grid in float64 with folds from numpy_folds(813, 10, 2, seed=0),
# from `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_ext_r2.py 1`.
# At its default key the JAX package's sweep collapses to the all-zero
# weights for bio_12 in its first zoom round (its r² ensemble NaN): that
# response is held to the candidate the sweep had picked before it and to
# the L-BFGS-B search.
JAX_REFERENCE_EXT = {
    "bio_1": {"kept": "gm", "weights": [0.16559567431263794, 0.7079099958761527],
              "r2_ensemble": 0.8640014163730194, "r2_final": 0.9944916398648972, "aicc": "m", "lbfgsb": "gm",
              "cv_rss": [367838.32533441717, 261082.0925140633], "sweep_collapse_round": None,
              "sweep_before_collapse": [0.16559567431263794, 0.7079099958761527]},
    "bio_12": {"kept": "g", "weights": [0.0, 0.0], "r2_ensemble": float("nan"), "r2_final": 1.0, "aicc": "m",
               "lbfgsb": "gm", "cv_rss": [52139201.79313878, 35165227.38022414], "sweep_collapse_round": 0,
               "sweep_before_collapse": [0.03957906582694237, 0.5404866370528085]},
}
CV_RSS_RTOL = 1e-6
# the sweep's weights against the JAX package's on the same draws: the
# residual matrices agree to ~1e-15 (their sums of squares), so the same
# candidates and perturbations are taken and the weights agree to round-off
SWEEP_ATOL = 1e-9


def _record_module(name: str):
    """A recorder under tools/ (its draws; JAX is imported only inside its
    record function)."""
    return importlib.import_module(f"tools.{name}")


def _nystrom_reference() -> dict:
    with open(os.path.join("tools", "record_jax_nystrom.json")) as f:
        return json.load(f)


def _signal_r2(fitted, signal) -> float:
    import numpy as np

    fitted, signal = np.asarray(fitted, np.float64), np.asarray(signal, np.float64)
    return float(1.0 - np.sum((fitted - signal) ** 2) / np.sum((signal - signal.mean()) ** 2))


def _k1_bound_ms(cells: int, n_knots: int, n_resp: int) -> tuple:
    """K1's least time for ``cells`` x ``n_knots`` at ``n_resp`` responses,
    reckoned as phase_kernel_k1 does: (bound ms, "operations" or "bytes")."""
    ops = cells * n_knots * (8 + 2 * n_resp)
    nbytes = 4 * (n_resp * cells + 2 * n_knots + n_resp * n_knots + 3 * n_resp)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _k1_against_plain(model, sub, block_rows: int) -> dict:
    """K1 on ``sub`` against its plain version from the same float32 tables:
    max error, tolerance (K1_TOL of max |surface|), CUDA-event ms of K1 (a
    median of 5 after a warm-up) and of the plain version's one pass, and
    the bound."""
    import torch

    from machisplin_tpu_torch.ops import tps_grid

    tab = tps_grid.grid_tables(model, sub, torch.float32)
    got = tps_grid.tps_grid_cuda(tab, sub)
    # the plain version is timed on its one checking pass (seconds a band)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    want = tps_grid.tps_grid_plain(tab, sub, block_rows=block_rows)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    del got, want
    ms = cuda_ms(lambda: tps_grid.tps_grid_cuda(tab, sub), reps=5)
    n_resp, n_pad = tab.c.shape
    bound, by = _k1_bound_ms(sub.ncell, n_pad, n_resp)
    return {"rows": sub.nrows, "cols": sub.ncols, "knots_evaluated": n_pad, "responses": n_resp,
            "max_abs_err": err, "max_abs_surface": scale, "tolerance": K1_TOL * scale, "ok": err <= K1_TOL * scale,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def _lam_steps(got, want) -> float:
    """|log10(got / want)| in decades, largest over responses."""
    import numpy as np

    return float(np.max(np.abs(np.log10(np.asarray(got, np.float64) / np.asarray(want, np.float64)))))


def _stream_surface(model, grid, rows: int, cells=None):
    """Predict ``grid`` in ``rows``-row panels on K1 with a device-side
    checksum and one synchronise; ``cells`` (k, 2) row, col are gathered
    from the panels as they pass.  Returns (seconds, checksum, gathered
    (k,) or None, panels)."""
    import torch

    from machisplin_tpu_torch.ops.tps import tps_predict_grid

    acc = torch.zeros((), dtype=torch.float64, device="cuda")
    picked, panels = [], 0
    if cells is not None:
        rc = torch.as_tensor(cells, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r0 in range(0, grid.nrows, rows):
        sub = grid.subgrid(r0, min(r0 + rows, grid.nrows), 0, grid.ncols)
        surf = tps_predict_grid(model, sub)
        acc += torch.nansum(surf, dtype=torch.float64)
        if cells is not None:
            sel = (rc[:, 0] >= r0) & (rc[:, 0] < r0 + sub.nrows)
            picked.append((torch.nonzero(sel).flatten(), surf[rc[sel, 0] - r0, rc[sel, 1]]))
        panels += 1
    checksum = float(acc)
    dt = time.perf_counter() - t0
    gathered = None
    if cells is not None:
        gathered = torch.empty(len(cells), dtype=torch.float32, device="cuda")
        for idx, vals in picked:
            gathered[idx] = vals
        gathered = gathered.cpu().numpy()
    return dt, checksum, gathered, panels


def phase_tps_config4(ref: dict) -> dict:
    """BASELINE config 4, the north star's 100k stations over 10^8 cells:
    ``tps_fit_auto`` routes to Nystrom with 4,096 landmarks; the fit at the
    recorder's numpy landmarks against the JAX package's; the 10^8-cell
    surface in 1,536-row panels on K1; K1 against its plain version on one
    panel."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.grid import GridSpec
    from machisplin_tpu_torch.ops.nystrom import nystrom_tps_fit
    from machisplin_tpu_torch.ops.tps import _auto_route, tps_fit_auto
    from machisplin_tpu_torch.utils.timing import PhaseTimer

    rec = _record_module("record_jax_nystrom")
    jref = ref["config4"]
    t0 = time.perf_counter()
    coords_np, y_np = rec.config4_data()
    n = len(coords_np)
    coords = torch.as_tensor(coords_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    signal = np.sin(6 * coords_np[:, 0].astype(np.float64)) * np.cos(5 * coords_np[:, 1].astype(np.float64))
    failures = []
    route = _auto_route(n)
    if route != ("nystrom", CONFIG4["landmarks"]):
        failures.append(f"tps_fit_auto routes {n} stations to {route}, expected Nystrom with 4096 landmarks")
    _reset_launches()
    solve_s = []
    for _ in range(2):                       # first call, then warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model = tps_fit_auto(coords, y, generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t1)
    timer = PhaseTimer()
    nystrom_tps_fit(coords, y, m=CONFIG4["landmarks"], generator=torch.Generator().manual_seed(0), timer=timer)
    r2_signal = _signal_r2(model.fitted.cpu().numpy(), signal)
    if tuple(model.knots.shape) != (CONFIG4["landmarks"], 2):
        failures.append(f"the auto fit has {tuple(model.knots.shape)} knots")
    if not r2_signal >= SIGNAL_R2_MIN:
        failures.append(f"the card's own landmarks fit the signal to r2 {r2_signal}")

    # the recorder's numpy landmarks: against the JAX package
    idx = rec.landmark_idx(n, CONFIG4["landmarks"])
    pm = nystrom_tps_fit(coords, y, landmarks=coords[torch.as_tensor(idx, device="cuda")], chunk=NYS_CHUNK)
    span = float(np.ptp(y_np))
    st = rec.fixed_stations(n, 2000)
    fit_err = float(np.abs(pm.fitted.cpu().numpy()[st] - np.asarray(jref["fitted"])).max())
    parity = {
        "lam": float(pm.lam), "lam_jax": jref["lam"], "lam_decades": _lam_steps(float(pm.lam), jref["lam"]),
        "gcv": float(pm.gcv), "gcv_jax": jref["gcv"], "eff_df": float(pm.eff_df), "eff_df_jax": jref["eff_df"],
        "fitted_max_err": fit_err, "fitted_tol": NYS_FIT_TOL * span,
    }
    if parity["lam_decades"] > NYS_LAM_DECADES:
        failures.append(f"config4 lambda {parity['lam']} vs the JAX package's {jref['lam']}")
    for k in ("gcv", "eff_df"):
        if not abs(parity[k] - jref[k]) <= NYS_REL * abs(jref[k]):
            failures.append(f"config4 {k} {parity[k]} vs the JAX package's {jref[k]}")
    if not fit_err <= NYS_FIT_TOL * span:
        failures.append(f"config4 fitted values {fit_err} from the JAX package's (tol {NYS_FIT_TOL * span})")

    side = CONFIG4["side"]
    grid = GridSpec(nrows=side, ncols=side, xmin=0.0, ymax=1.0, dx=1.0 / side, dy=1.0 / side)
    cells = rec.fixed_cells(side, 4096)
    launches0 = _read_launches()["tps_grid"]
    predict_s, checksum, surf_cells, panels = _stream_surface(pm, grid, CONFIG4["panel_rows"], cells)
    launches = _read_launches()              # the path's own, before the check's launches
    k1_launches = launches["tps_grid"] - launches0
    surf_err = float(np.abs(surf_cells - np.asarray(jref["surface"])).max())
    parity.update(surface_max_err=surf_err, surface_tol=NYS_SURF_TOL * span)
    if not surf_err <= NYS_SURF_TOL * span:
        failures.append(f"config4 surface cells {surf_err} from the JAX package's (tol {NYS_SURF_TOL * span})")
    if not np.isfinite(checksum):
        failures.append("config4 surface is not finite")
    if k1_launches != panels:
        failures.append(f"K1 launched {k1_launches} times for {panels} panels")
    panel = _k1_against_plain(pm, grid.subgrid(0, CONFIG4["panel_rows"], 0, side), block_rows=4)
    if not panel["ok"]:
        failures.append(f"K1 disagrees with its plain version at 4096 knots: {panel['max_abs_err']}")
    whole_bound, _ = _k1_bound_ms(grid.ncell, panel["knots_evaluated"], 1)
    res = {
        "phase": "tps_config4", "seconds": time.perf_counter() - t0, "stations": n, "route": list(route),
        "landmarks": CONFIG4["landmarks"], "solve_first_s": solve_s[0], "solve_warm_s": solve_s[1],
        "solve_steps_s": timer.as_dict(), "r2_signal": r2_signal, "parity": parity,
        "grid": [side, side], "cells": grid.ncell, "panel_rows": CONFIG4["panel_rows"], "panels": panels,
        "predict_s": predict_s, "mcells_per_s": grid.ncell / predict_s / 1e6, "checksum": checksum,
        "k1_launches": k1_launches, "knots_evaluated": panel["knots_evaluated"],
        "k1_panel": panel, "k1_grid_bound_ms": whole_bound, "launches": launches,
    }
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def phase_tps_config3(ref: dict) -> dict:
    """BASELINE config 3: 10,000 stations x 19 responses through
    ``tps_fit_auto`` (Nystrom, 2,048 landmarks), held to the JAX package at
    the recorder's landmarks; the first 8,192 stations through the exact
    device path; 3,000 through the host float64 path (``method="exact"``
    above ``max_device_knots``), held to the card's exact float64 fit and
    the JAX package's host fit; all 19 surfaces over 3,163 x 3,163 cells on
    K1 (3 launches a call: 8 + 8 + 3 responses)."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.grid import GridSpec
    from machisplin_tpu_torch.ops.nystrom import nystrom_tps_fit
    from machisplin_tpu_torch.ops.tps import _auto_route, tps_fit, tps_fit_auto, tps_predict_grid

    rec = _record_module("record_jax_nystrom")
    jref = ref["config3"]
    t0 = time.perf_counter()
    coords_np, ys_np = rec.config3_data()
    n, n_resp = ys_np.shape
    coords = torch.as_tensor(coords_np, device="cuda")
    ys = torch.as_tensor(ys_np, device="cuda")
    failures, fits = [], {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        fits[name] = {"seconds": time.perf_counter() - t1}
        return out

    _reset_launches()
    route = _auto_route(n)
    auto = timed("nystrom_auto", lambda: tps_fit_auto(coords, ys, generator=torch.Generator().manual_seed(0)))
    if route != ("nystrom", CONFIG3["landmarks"]) or tuple(auto.knots.shape) != (CONFIG3["landmarks"], 2):
        failures.append(f"config3 routes to {route} with {tuple(auto.knots.shape)} knots")
    idx = torch.as_tensor(rec.landmark_idx(n, CONFIG3["landmarks"]), device="cuda")
    pm = timed("nystrom_jax_landmarks", lambda: nystrom_tps_fit(coords, ys, landmarks=coords[idx], chunk=NYS_CHUNK))
    st = rec.fixed_stations(n, 200)
    span = np.ptp(ys_np, axis=0)
    fit_err = np.abs(pm.fitted.cpu().numpy()[st] - np.asarray(jref["fitted"])) / span
    fits["nystrom_jax_landmarks"].update(lam_decades=_lam_steps(pm.lam.cpu().numpy(), jref["lam"]),
                                         fitted_max_err_of_range=float(fit_err.max()))
    if fits["nystrom_jax_landmarks"]["lam_decades"] > NYS_LAM_DECADES:
        failures.append(f"config3 lambdas {pm.lam.tolist()} vs the JAX package's {jref['lam']}")
    if not fit_err.max() <= NYS_FIT_TOL:
        failures.append(f"config3 fitted values {fit_err.max()} of the range from the JAX package's")

    ne = CONFIG3["exact"]
    exact = timed("exact_device", lambda: tps_fit_auto(coords[:ne], ys[:ne]))
    fits["exact_device"].update(route=_auto_route(ne)[0], dtype=str(exact.c.dtype),
                                lam_range=[float(exact.lam.min()), float(exact.lam.max())])
    if _auto_route(ne)[0] != "exact" or tuple(exact.c.shape) != (ne, n_resp) or not torch.isfinite(exact.c).all():
        failures.append("config3 exact device fit failed")
    nh = CONFIG3["host"]
    host = timed("exact_host", lambda: tps_fit_auto(coords[:nh], ys[:nh], method="exact",
                                                      max_device_knots=CONFIG3["host_limit"]))
    dev64 = timed("exact_device_f64", lambda: tps_fit(coords[:nh].double(), ys[:nh].double()))
    host_lam, dev_lam = host.lam.double().cpu().numpy(), dev64.lam.cpu().numpy()
    host_fit_err = float((host.fitted.double() - dev64.fitted).abs().max().cpu() / float(span.max()))
    fits["exact_host"].update(
        route=_auto_route(nh, "exact", CONFIG3["host_limit"])[0], device=str(host.c.device),
        lam_rel_to_jax=float(np.max(np.abs(host_lam / np.asarray(jref["host_lam"]) - 1))),
        lam_rel_to_device_f64=float(np.max(np.abs(host_lam / dev_lam - 1))), fitted_err_to_device_f64=host_fit_err)
    if _auto_route(nh, "exact", CONFIG3["host_limit"])[0] != "host" or host.c.device.type != "cuda":
        failures.append("config3 host fit did not route to the host or return to the card")
    if not fits["exact_host"]["lam_rel_to_jax"] <= HOST_LAM_RTOL:
        failures.append(f"config3 host lambdas {host_lam} vs the JAX package's {jref['host_lam']}")
    if not (fits["exact_host"]["lam_rel_to_device_f64"] <= HOST_DEV_LAM_RTOL and host_fit_err <= HOST_DEV_FIT_TOL):
        failures.append(f"config3 host fit against the card's float64 exact fit: {fits['exact_host']}")

    # the card's eigh at the exact path's knot limit (MAX_DEVICE_EIGH_KNOTS,
    # kept from the JAX package's TPU memory ceiling): time and workspace
    eigh = {}
    for dt in (torch.float32, torch.float64):
        g = torch.Generator(device="cuda").manual_seed(0)
        a = torch.randn((ne, ne), generator=g, dtype=dt, device="cuda")
        sym = 0.5 * (a + a.T)
        del a
        torch.linalg.eigh(sym[:64, :64])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.linalg.eigh(sym)
        e1.record()
        torch.cuda.synchronize()
        eigh[str(dt).replace("torch.", "")] = {"n": ne, "ms": e0.elapsed_time(e1),
                                               "workspace_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        del sym

    side = CONFIG3["side"]
    grid = GridSpec(nrows=side, ncols=side, xmin=0.0, ymax=1.0, dx=1.0 / side, dy=1.0 / side)
    launches0 = _read_launches()["tps_grid"]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    surf = tps_predict_grid(pm, grid)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t1
    launches = _read_launches()              # the path's own, before the check's launches
    k1_launches = launches["tps_grid"] - launches0
    if tuple(surf.shape) != (side, side, n_resp) or not torch.isfinite(surf).all():
        failures.append("config3 surfaces are not finite (side, side, 19)")
    if k1_launches != 3:
        failures.append(f"K1 launched {k1_launches} times for 19 responses, expected 3 (8 + 8 + 3)")
    del surf
    panel = _k1_against_plain(pm, grid.subgrid(0, 64, 0, side), block_rows=4)
    if not panel["ok"]:
        failures.append(f"K1 disagrees with its plain version at 19 responses: {panel['max_abs_err']}")
    whole_bound, _ = _k1_bound_ms(grid.ncell, panel["knots_evaluated"], n_resp)
    res = {
        "phase": "tps_config3", "seconds": time.perf_counter() - t0, "stations": n, "responses": n_resp,
        "fits": fits, "eigh": eigh, "grid": [side, side], "cells": grid.ncell, "predict_s": predict_s,
        "mcells_per_s": grid.ncell / predict_s / 1e6, "k1_launches": k1_launches, "k1_panel_64_rows": panel,
        "k1_grid_bound_ms": whole_bound, "launches": launches,
    }
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def phase_tps_config5() -> dict:
    """BASELINE config 5: 500,000 stations, ``tps_fit_auto`` (Nystrom, 4,096
    landmarks), the ~10^9-cell surface streamed in 2,048-row bands on K1, K1
    against its plain version on one band, the fit against the signal."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.grid import GridSpec
    from machisplin_tpu_torch.ops.tps import _auto_route, tps_fit_auto

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)           # as benchmarks/run_configs.config5 draws them
    n = CONFIG5["stations"]
    coords_np = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    y_np = (np.sin(8 * coords_np[:, 0]) * np.cos(7 * coords_np[:, 1]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    coords = torch.as_tensor(coords_np, device="cuda")
    y = torch.as_tensor(y_np, device="cuda")
    failures = []
    route = _auto_route(n)
    _reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = tps_fit_auto(coords, y, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    signal = np.sin(8 * coords_np[:, 0].astype(np.float64)) * np.cos(7 * coords_np[:, 1].astype(np.float64))
    r2_signal = _signal_r2(model.fitted.cpu().numpy(), signal)
    if route != ("nystrom", CONFIG5["landmarks"]) or tuple(model.knots.shape) != (CONFIG5["landmarks"], 2):
        failures.append(f"config5 routes to {route} with {tuple(model.knots.shape)} knots")
    if not r2_signal >= SIGNAL_R2_MIN:
        failures.append(f"config5 fits the signal to r2 {r2_signal}")
    side = CONFIG5["side"]
    grid = GridSpec(nrows=side, ncols=side, xmin=0.0, ymax=1.0, dx=1.0 / side, dy=1.0 / side)
    predict_s, checksum, _, bands = _stream_surface(model, grid, CONFIG5["band_rows"])
    launches = _read_launches()              # the path's own, before the check's launches
    if launches["tps_grid"] != bands:
        failures.append(f"K1 launched {launches['tps_grid']} times for {bands} bands")
    if not np.isfinite(checksum):
        failures.append("config5 surface is not finite")
    band = _k1_against_plain(model, grid.subgrid(0, CONFIG5["band_rows"], 0, side), block_rows=2)
    if not band["ok"]:
        failures.append(f"K1 disagrees with its plain version on a config5 band: {band['max_abs_err']}")
    whole_bound, _ = _k1_bound_ms(grid.ncell, band["knots_evaluated"], 1)
    res = {
        "phase": "tps_config5", "seconds": time.perf_counter() - t0, "stations": n, "route": list(route),
        "solve_s": solve_s, "r2_signal": r2_signal, "grid": [side, side], "cells": grid.ncell,
        "band_rows": CONFIG5["band_rows"], "bands": bands, "surface_s": predict_s,
        "mcells_per_s": grid.ncell / predict_s / 1e6, "checksum": checksum, "k1_band": band,
        "k1_grid_bound_ms": whole_bound, "launches": launches,
    }
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def phase_mltps_ext_f64() -> dict:
    """mltps on the full grid in float64 with the extension options
    (EXT_CONFIG of tools/record_jax_ext_r2.py) on the recorder's folds and
    with the JAX package's sweep draws (the recorder's SWEEP_DRAWS), held
    to the JAX package's run: each response's CV residuals (their sums of
    squares per letter within CV_RSS_RTOL), ``optimize_weights_aicc`` on
    the residual matrix picking the JAX package's subset, and the sweep on
    that matrix ending at the JAX package's weights (SWEEP_ATOL) with its
    kept letters and r² within R2_TOL.  Where the JAX package's sweep
    collapsed to the all-zero weights (its ensemble NaN; the port's sweep
    never takes them), the port's sweep run only to the round of that
    collapse (the later rounds' perturbations zero) must reach the JAX
    package's weights before it, and its full search is held to the
    L-BFGS-B search on the same matrix: the JAX package's L-BFGS-B letters,
    and an objective no more than 0.1 % above the port's L-BFGS-B
    objective."""
    import numpy as np
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.cv import CVConfig
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.ensemble.weights import (
        optimize_weights_aicc, optimize_weights_lbfgsb, optimize_weights_sweep,
    )

    rec = _record_module("record_jax_ext_r2")
    pipe = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")
    t0 = time.perf_counter()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    cov = mtt.Raster(cov.data.to(torch.float64), cov.grid, cov.names)
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    config = pipe.MLTPSConfig(cv=CVConfig(gam=rec.SMOOTH, mars=rec.MARS2), **rec.EXT_CONFIG)
    seen = []
    sweep = pipe.optimize_weights_sweep
    with np.load(rec.SWEEP_DRAWS) as f:
        draws = {k: torch.as_tensor(f[k]) for k in ("cands", "noise")}

    def capture(rmat, letters):
        seen.append(rmat)
        return sweep(rmat, letters, **draws)

    timer = mtt.PhaseTimer()
    _reset_launches()
    pipe.optimize_weights_sweep = capture
    try:
        t1 = time.perf_counter()
        out = mtt.mltps(s, cov, tps=True, config=config, folds=folds, generator=torch.Generator().manual_seed(0),
                        device="cuda", timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        pipe.optimize_weights_sweep = sweep
    launches = _read_launches()
    mask = torch.isfinite(cov.data).all(0)
    layers, failures = {}, []
    for r, rmat in zip(out, seen):
        ref = JAX_REFERENCE_EXT[r.name]
        lb = optimize_weights_lbfgsb(rmat.cpu().numpy(), "gm")
        got = {"kept": r.summary["best model(s):"], "weights": [float(v) for v in r.weights.weights],
               "percent": r.summary["ensemble weights:"], "r2_ensemble": r.summary["r2 ensemble:"],
               "r2_final": r.summary["r2 final:"], "objective": r.weights.objective,
               "aicc": optimize_weights_aicc(rmat, "gm").letters, "lbfgsb": lb.letters,
               "lbfgsb_objective": lb.objective, "cv_rss": (rmat**2).sum(1).tolist(),
               "gam_edf": r.var_imp.get("gam", {}).get("edf"), "jax_sweep_collapsed": sum(ref["weights"]) == 0}
        # the sweep up to the JAX package's collapse (all its rounds if none)
        upto = ref["sweep_collapse_round"]
        noise = draws["noise"].clone()
        noise[upto if upto is not None else len(noise):] = 0.0
        before = optimize_weights_sweep(rmat, "gm", cands=draws["cands"], noise=noise).weights
        got["sweep_before_collapse"] = [float(v) for v in before]
        got["sweep_before_collapse_err"] = float(np.abs(before - np.asarray(ref["sweep_before_collapse"])).max())
        layers[r.name] = got
        if not got["sweep_before_collapse_err"] <= SWEEP_ATOL:
            failures.append(f"{r.name} sweep weights {got['sweep_before_collapse']} before round {upto}, the JAX "
                            f"package's {ref['sweep_before_collapse']}")
        for attr in ("final", "ensemble", "tps_surface"):
            d = getattr(r, attr).data
            if tuple(d.shape) != cov.grid.shape or not torch.isfinite(d[mask]).all():
                failures.append(f"{r.name}.{attr} is not finite over the covariate mask")
        for a, b in zip(got["cv_rss"], ref["cv_rss"]):
            if not abs(a - b) <= CV_RSS_RTOL * abs(b):
                failures.append(f"{r.name} CV residual sums {got['cv_rss']} vs the JAX package's {ref['cv_rss']}")
        if got["aicc"] != ref["aicc"]:
            failures.append(f"{r.name} AICc subset {got['aicc']!r}, the JAX package's {ref['aicc']!r}")
        if got["jax_sweep_collapsed"]:
            if not (sum(got["weights"]) > 0 and got["kept"] == ref["lbfgsb"]
                    and got["objective"] <= 1.001 * lb.objective):
                failures.append(f"{r.name}: the sweep {got['kept']!r} {got['objective']} against L-BFGS-B "
                                f"{ref['lbfgsb']!r} {lb.objective}")
            continue
        if got["kept"] != ref["kept"]:
            failures.append(f"{r.name} kept {got['kept']!r}, the JAX package's {ref['kept']!r}")
        if not np.abs(np.asarray(got["weights"]) - np.asarray(ref["weights"])).max() <= SWEEP_ATOL:
            failures.append(f"{r.name} sweep weights {got['weights']}, the JAX package's {ref['weights']}")
        for key in ("r2_ensemble", "r2_final"):
            if not abs(got[key] - ref[key]) <= R2_TOL["float64"]:
                failures.append(f"{r.name} {key} {got[key]} vs the JAX package's {ref[key]}")
    emit({
        "phase": "mltps_ext_f64", "seconds": time.perf_counter() - t0, "mltps_wall_s": wall,
        "grid": list(cov.grid.shape), "stations": n, "dtype": str(cov.data.dtype), "phases_s": timer.as_dict(),
        "launches": launches, "layers": layers, "jax_reference": JAX_REFERENCE_EXT, "r2_tol": R2_TOL["float64"],
    })
    if launches["tps_grid"] != 6:
        failures.append(f"K1 launched {launches['tps_grid']} times in the tile loop, expected one a live tile (6)")
    if failures:
        raise RuntimeError("; ".join(failures))
    return launches


def phase_rf_finals_unmerged() -> dict:
    """The RF pool at downsample 4 with ``batch_final_rf`` False and then
    True from the same generator seed: the same forests, so the ensembles
    agree within MERGE_TOL of their range; K3 launches of each (a raster
    stream per response against one)."""
    import numpy as np
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    t0 = time.perf_counter()
    cov = mtt.synthetic_covariates(downsample=4, device="cuda")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    runs, failures = {}, []
    for batch in (False, True):
        timer = mtt.PhaseTimer()
        _reset_launches()
        out = mtt.mltps(s, cov, tps=False, config=MLTPSConfig(letters_pool="r", batch_final_rf=batch), folds=folds,
                        generator=torch.Generator().manual_seed(0), device="cuda", timer=timer)
        torch.cuda.synchronize()
        runs[batch] = (out, _read_launches(), timer.as_dict())
    res = {"phase": "rf_finals_unmerged", "grid": list(cov.grid.shape), "stations": n,
           "k3_launches_unmerged": runs[False][1]["forest_predict"], "k3_launches_merged": runs[True][1]["forest_predict"],
           "phases_s_unmerged": runs[False][2], "phases_s_merged": runs[True][2], "layers": {}}
    for a, b in zip(runs[False][0], runs[True][0]):
        da, db = a.ensemble.data, b.ensemble.data
        ok = torch.isfinite(db)
        span = float(db[ok].max() - db[ok].min())
        err = float((da[ok] - db[ok]).abs().max())
        res["layers"][a.name] = {"kept": [a.summary["best model(s):"], b.summary["best model(s):"]],
                                 "max_abs_diff": err, "range": span}
        if not (torch.equal(torch.isfinite(da), ok) and err <= MERGE_TOL * span):
            failures.append(f"{a.name}: unmerged RF surface differs from the merged one by {err} (range {span})")
    if not res["k3_launches_unmerged"] > res["k3_launches_merged"] > 0:
        failures.append(f"K3 launches unmerged {res['k3_launches_unmerged']} vs merged {res['k3_launches_merged']}")
    res["seconds"] = time.perf_counter() - t0
    res["launches"] = {"forest_predict": res["k3_launches_unmerged"] + res["k3_launches_merged"]}
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


# ---------------------------------------------------------------- the mesh

MESH_RANKS = 2                 # ranks of mesh_main and mesh_config4_2r on the one card (gloo)
MESH_TIMEOUT_S = 600           # every collective's timeout, and the wait for a phase's ranks
MESH_R2_TOL = 1e-4             # r^2 ensemble and final against mltps_main's
MESH_RASTER_TOL = 1e-5         # final rasters, of max |surface|
MESH_GM_TOL = 1e-6             # GAM and MARS CV residuals, of their range (batched solves of another width)
MESH_NYS_TOL64 = 1e-9          # float64 Nystrom fitted values and d against the unsharded fit, of their scale
# float64 Nystrom radial coefficients: they solve the ill-conditioned whitened
# system, held as tests/test_torch_nystrom.py holds them (COEF_TOL)
MESH_NYS_COEF_TOL = 1e-6


def _record_cv(store: dict):
    """Keep the CV residuals of the next ``mltps`` call in ``store``
    ({letter: (R, n) numpy}); returns the function that undoes the wrap."""
    import numpy as np

    mod = sys.modules["machisplin_tpu_torch.pipeline.mltps"]
    orig = mod.run_cv

    def wrapped(*a, **k):
        out = orig(*a, **k)
        store.update({letter: np.asarray(v) for letter, v in out.items()})
        return out

    mod.run_cv = wrapped
    return lambda: setattr(mod, "run_cv", orig)


def _layer_arrays(results) -> dict:
    """Each LayerResult as host arrays and plain values."""
    import numpy as np

    return {r.name: {
        "final": r.final.data.cpu().numpy(), "ensemble": r.ensemble.data.cpu().numpy(),
        "tps": r.tps_surface.data.cpu().numpy(), "residuals": np.asarray(r.residuals),
        "kept": r.summary["best model(s):"], "percent": r.summary["ensemble weights:"],
        "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"],
        "var_imp": repr(r.var_imp),
    } for r in results}


def _same_value(a, b) -> bool:
    """Bit for bit (floats by their bytes, NaN included), else ==."""
    import numpy as np

    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_value(a[k], b[k]) for k in a)
    return a == b


def _mesh_worker(rank, world, store, backend, out_dir, job, args):
    """One rank of a mesh phase: joins the process group, builds the mesh,
    runs ``job`` and saves its result for the parent."""
    import datetime

    import torch
    import torch.distributed as dist

    logging.basicConfig(stream=sys.stderr, level=logging.WARNING, format=f"rank {rank} %(name)s: %(message)s")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S), **kw)
    try:
        from machisplin_tpu_torch.parallel import make_mesh

        mesh = make_mesh()
        out = {"main": _mesh_job_main, "nccl1": _mesh_job_nccl1, "config4": _mesh_job_config4}[job](mesh, args)
        out["rank"] = rank
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _run_ranks(job: str, world: int, backend: str, args: dict) -> list:
    """Start ``world`` ranks of ``job`` (spawn, a ``file://`` store), wait
    for them with MESH_TIMEOUT_S, and return each rank's result; a rank
    that fails, or a phase past its time, fails the phase and stops every
    rank."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix=f"mesh_{job}_")
    try:
        ctx = mp.start_processes(_mesh_worker, args=(world, os.path.join(out_dir, "store"), backend, out_dir, job,
                                                     args), nprocs=world, join=False, start_method="spawn")
        deadline = time.perf_counter() + MESH_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"mesh phase {job}: the ranks ran past {MESH_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _mesh_job_main(mesh, args):
    """The north-star call of ``mltps_main`` under ``MLTPSConfig(mesh=)``."""
    import torch

    import machisplin_tpu_torch as mtt

    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    s = mtt.load_sampling()
    cv_res: dict = {}
    timer = mtt.PhaseTimer()
    restore = _record_cv(cv_res)
    _reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    try:
        out = mtt.mltps(s, cov, tps=True, folds=args["folds"], generator=torch.Generator().manual_seed(0),
                        device="cuda", timer=timer, config=mtt.MLTPSConfig(mesh=mesh))
    finally:
        restore()
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t1, "launches": _read_launches(), "phases_s": timer.as_dict(),
            "cv": cv_res, "layers": _layer_arrays(out)}


def _north_star_tiles():
    """The north-star grid's live TPS tiles as ``mltps`` packs them
    (float32), with each response's station values less their mean as the
    residuals: (coords, y, mask, origins, tile_shape, cell)."""
    import numpy as np
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.parallel import pack_tiles

    mod = sys.modules["machisplin_tpu_torch.pipeline.mltps"]
    rast, _, coords, _, responses = mod._prepare_inputs(mtt.load_sampling(),
                                                         mtt.synthetic_covariates(downsample=1, device="cuda"))
    cfg = mtt.MLTPSConfig()
    _, _, fit_exts, _ = mod._tps_tiles(rast.grid, cfg)
    res = np.stack([v - v.mean() for v in responses.values()], 1)
    crops = [mtt.crop(rast.band(0), e) for e in fit_exts]
    sels = [torch.isfinite(mtt.extract(c, coords[:, 0], coords[:, 1])).cpu().numpy() for c in crops]
    live = [h for h in range(len(crops)) if int(sels[h].sum()) >= cfg.min_tile_points]
    budget = -(-max(int(sels[h].sum()) for h in live) // 64) * 64
    ct, yt, mt_ = pack_tiles([coords[sels[h]] for h in live], [res[sels[h]] for h in live], pad_to=budget,
                             dtype=rast.data.dtype, device="cuda")
    origins = torch.tensor([(crops[h].grid.xmin, crops[h].grid.ymax) for h in live], dtype=torch.float64)
    shape = (max(crops[h].grid.nrows for h in live), max(crops[h].grid.ncols for h in live))
    return ct, yt, mt_, origins, shape, (crops[live[0]].grid.dx, crops[live[0]].grid.dy)


def _nystrom_gaps(got, want) -> dict:
    """Largest gaps of a Nystrom fit from another, each of the other's
    scale; lambda's in decades (0 on the same grid point)."""
    import numpy as np

    out = {"lam": float(got.lam), "lam_decades": _lam_steps(float(got.lam), float(want.lam))}
    for key in ("c", "d", "fitted"):
        a, b = (getattr(m, key).double().cpu().numpy() for m in (got, want))
        out[key + "_gap"] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        out[key + "_bit_equal"] = a.tobytes() == b.tobytes()
    return out


def _config4_fits(mesh, dtype):
    """config 4's Nystrom fit at the recorder's landmarks, unsharded and
    over ``mesh``, in ``dtype``: (unsharded, sharded, sharded seconds)."""
    import torch

    from machisplin_tpu_torch.ops.nystrom import nystrom_tps_fit

    rec = _record_module("record_jax_nystrom")
    coords_np, y_np = rec.config4_data()
    coords = torch.as_tensor(coords_np, device="cuda").to(dtype)
    y = torch.as_tensor(y_np, device="cuda").to(dtype)
    lm = coords[torch.as_tensor(rec.landmark_idx(len(coords_np), CONFIG4["landmarks"]), device="cuda")]
    ref = nystrom_tps_fit(coords, y, landmarks=lm, chunk=NYS_CHUNK)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = nystrom_tps_fit(coords, y, landmarks=lm, chunk=NYS_CHUNK, mesh=mesh)
    torch.cuda.synchronize()
    return ref, got, time.perf_counter() - t1


def _mesh_job_nccl1(mesh, args):
    """World size 1 on NCCL: config 4's float64 Nystrom fit and the
    north-star grid's TPS tiles, each against its unsharded call."""
    import torch

    from machisplin_tpu_torch.parallel import batched_tile_tps

    ref, got, fit_s = _config4_fits(mesh, torch.float64)
    ct, yt, mt_, origins, shape, cell = _north_star_tiles()
    kw = dict(tile_shape=shape, cell=cell)
    _reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    surf = batched_tile_tps(ct, yt, mt_, origins, mesh=mesh, **kw)
    torch.cuda.synchronize()
    tiles_s = time.perf_counter() - t1
    launches = _read_launches()
    plain = batched_tile_tps(ct, yt, mt_, origins, **kw)
    return {"nystrom": _nystrom_gaps(got, ref), "nystrom_s": fit_s, "tiles": int(ct.shape[0]),
            "tile_shape": list(shape), "tiles_s": tiles_s, "launches": launches,
            "tiles_bit_equal": bool(torch.equal(surf, plain)),
            "tiles_max_abs_err": float((surf - plain).abs().max())}


def _mesh_job_config4(mesh, args):
    """config 4's Nystrom fit over the ranks, float64 and float32."""
    import torch

    out = {}
    for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        ref, got, fit_s = _config4_fits(mesh, dtype)
        out[name] = dict(_nystrom_gaps(got, ref), seconds=fit_s,
                         fitted=got.fitted.double().cpu().numpy(), c=got.c.double().cpu().numpy())
    return out


def _ranks_agree(ranks: list, keys) -> list:
    """Failures where a rank's ``keys`` differ from rank 0's."""
    return [f"rank {r['rank']}: {k} differs from rank 0's" for r in ranks[1:] for k in keys
            if not _same_value(r[k], ranks[0][k])]


def phase_mesh_main(keep: dict, world: int = MESH_RANKS, backend: str = "gloo") -> dict:
    """mltps_main's call under MLTPSConfig(mesh=make_mesh()) over ``world``
    ranks, held to mltps_main's run: the CV residuals of b, v and r bit for
    bit, g and m within MESH_GM_TOL and n within NN_TOL of their range;
    the same kept letters; r^2 within MESH_R2_TOL;
    final rasters within MESH_RASTER_TOL of max |surface|; every rank's
    LayerResults identical to rank 0's."""
    import numpy as np

    t0 = time.perf_counter()
    ranks = _run_ranks("main", world, backend, {"folds": keep["folds"]})
    failures = _ranks_agree(ranks, ("layers", "cv"))
    got = ranks[0]
    cv_tol = {"b": 0.0, "v": 0.0, "r": 0.0, "g": MESH_GM_TOL, "m": MESH_GM_TOL, "n": NN_TOL}
    cv = {}
    for letter, want in keep["cv"].items():
        a = got["cv"][letter]
        span = float(np.ptp(want))
        gap = float(np.abs(a - want).max()) / span
        cv[letter] = {"gap_of_range": gap, "bit_identical": _same_value(a, want), "tol": cv_tol[letter]}
        if not (cv[letter]["bit_identical"] if cv_tol[letter] == 0.0 else gap <= cv_tol[letter]):
            failures.append(f"CV letter {letter}: {gap} of the range from mltps_main's (tol {cv_tol[letter]})")
    layers = {}
    for name, want in keep["layers"].items():
        lay = got["layers"][name]
        scale = float(np.nanmax(np.abs(want["final"])))
        err = float(np.nanmax(np.abs(lay["final"] - want["final"])))
        same_nan = bool((np.isnan(lay["final"]) == np.isnan(want["final"])).all())
        layers[name] = {"kept": lay["kept"], "kept_main": want["kept"], "final_gap_of_max": err / scale,
                        "final_bit_identical": _same_value(lay["final"], want["final"])}
        if lay["kept"] != want["kept"]:
            failures.append(f"{name} kept {lay['kept']!r}, mltps_main kept {want['kept']!r}")
        for key in ("r2_ensemble", "r2_final"):
            layers[name][key] = [lay[key], want[key]]
            if not abs(lay[key] - want[key]) <= MESH_R2_TOL:
                failures.append(f"{name} {key} {lay[key]} vs mltps_main's {want[key]}")
        if not (same_nan and err <= MESH_RASTER_TOL * scale):
            failures.append(f"{name} final raster {err} from mltps_main's (tol {MESH_RASTER_TOL} x {scale})")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    for k in ("tps_grid", "tree_grow", "forest_predict", "svm_sweep"):
        if not all(r["launches"][k] > 0 for r in ranks):
            failures.append(f"kernel {k} did not run on every rank: {[r['launches'][k] for r in ranks]}")
    res = {"phase": "mesh_main" if backend == "gloo" else "mesh_main_nccl", "seconds": time.perf_counter() - t0,
           "ranks": world, "backend": backend, "wall_s": [r["wall_s"] for r in ranks],
           "main_wall_s": keep["wall_s"], "phases_s": ranks[0]["phases_s"],
           "launches_per_rank": [r["launches"] for r in ranks], "launches": launches, "cv": cv, "layers": layers}
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def phase_mesh_nccl1() -> dict:
    """World size 1 on NCCL: config 4's float64 Nystrom fit through
    nystrom_tps_fit(mesh=) against the unsharded fit (lambda the same, c
    within MESH_NYS_COEF_TOL, d and fitted values within MESH_NYS_TOL64 of
    their scale; the gaps printed, 0 where bit-equal), and
    batched_tile_tps over the north-star grid's TPS tiles bit for bit."""
    t0 = time.perf_counter()
    got = _run_ranks("nccl1", 1, "nccl", {})[0]
    failures = []
    nys = got["nystrom"]
    if nys["lam_decades"] != 0.0:
        failures.append(f"Nystrom lambda {nys['lam']} is not the unsharded fit's")
    for key in ("c", "d", "fitted"):
        if not nys[key + "_gap"] <= (MESH_NYS_COEF_TOL if key == "c" else MESH_NYS_TOL64):
            failures.append(f"Nystrom {key}: {nys[key + '_gap']} of its scale from the unsharded fit")
    if not got["tiles_bit_equal"]:
        failures.append(f"batched_tile_tps under the mesh parts from the unsharded call: {got['tiles_max_abs_err']}")
    if got["launches"]["tps_grid"] != got["tiles"]:
        failures.append(f"K1 launched {got['launches']['tps_grid']} times for {got['tiles']} tiles")
    res = dict(got, phase="mesh_nccl1", seconds=time.perf_counter() - t0)
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def phase_mesh_config4_2r() -> dict:
    """config 4's Nystrom fit over MESH_RANKS gloo ranks on the card: float64
    against the unsharded fit as in mesh_nccl1 (lambda the same), float32
    on the same lambda with fitted values within NYS_FIT_TOL of the range
    (summation order moves float32 Nystrom fits); every rank the same."""
    import numpy as np

    t0 = time.perf_counter()
    ranks = _run_ranks("config4", MESH_RANKS, "gloo", {})
    failures = [f"rank {r['rank']}: {name} {key} differs from rank 0's" for r in ranks[1:]
                for name in ("float64", "float32") for key in ("lam", "fitted", "c")
                if not _same_value(r[name][key], ranks[0][name][key])]
    rec = _record_module("record_jax_nystrom")
    span = float(np.ptp(rec.config4_data()[1]))
    out = {}
    for name in ("float64", "float32"):
        g = {k: v for k, v in ranks[0][name].items() if k not in ("fitted", "c")}
        out[name] = g
        if g["lam_decades"] != 0.0:
            failures.append(f"{name}: lambda {g['lam']} is not the unsharded fit's grid point")
    for key in ("c", "d", "fitted"):
        if not out["float64"][key + "_gap"] <= (MESH_NYS_COEF_TOL if key == "c" else MESH_NYS_TOL64):
            failures.append(f"float64 {key}: {out['float64'][key + '_gap']} of its scale from the unsharded fit")
    fit_gap32 = out["float32"]["fitted_gap"] * float(np.abs(ranks[0]["float32"]["fitted"]).max())
    out["float32"]["fitted_gap_of_range"] = fit_gap32 / span
    if not fit_gap32 <= NYS_FIT_TOL * span:
        failures.append(f"float32 fitted values {fit_gap32} from the unsharded fit's (tol {NYS_FIT_TOL * span})")
    res = {"phase": "mesh_config4_2r", "seconds": time.perf_counter() - t0, "ranks": MESH_RANKS, **out}
    emit(res)
    if failures:
        raise RuntimeError("; ".join(failures))
    return res


def main() -> int:
    logging.basicConfig(stream=sys.stderr, level=logging.INFO, format="%(name)s: %(message)s")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import machisplin_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_build()
    k1 = phase_kernel_k1()
    phase_mltps_gm("float32")
    phase_mltps_gm("float64")
    k2 = phase_kernel_k2()
    captured: dict = {}
    phase_mltps_b(captured)
    k3 = phase_kernel_k3(captured)
    phase_nn_lbfgs()
    phase_mltps_bn()
    k4 = phase_kernel_svm()
    main_keep: dict = {}
    launches = phase_mltps_main(main_keep)
    phase_cv_b_8000()
    phase_mltps_one()
    keep: dict = {}
    phase_tiles_main(keep)
    phase_resume_tile(keep)
    phase_cv_b_perfold()
    nys_ref = _nystrom_reference()
    c4 = phase_tps_config4(nys_ref)
    c3 = phase_tps_config3(nys_ref)
    c5 = phase_tps_config5()
    ext = phase_mltps_ext_f64()
    rf_un = phase_rf_finals_unmerged()
    mesh = phase_mesh_main(main_keep)
    if torch.cuda.device_count() >= 2:
        phase_mesh_main(main_keep, world=min(torch.cuda.device_count(), 4), backend="nccl")
    else:
        print("mesh_main_nccl: not run: this machine has one CUDA device, and NCCL takes one rank a device",
              flush=True)
    main_keep.clear()
    nccl1 = phase_mesh_nccl1()
    phase_mesh_config4_2r()
    # K1's launches: the main path's and the large-station paths' and the
    # tile loop's; K3's: the main path's and the unmerged/merged RF finals'
    launches["tps_grid"] += sum(p["launches"]["tps_grid"] for p in (c4, c3, c5)) + ext["tps_grid"]
    launches["forest_predict"] += rf_un["launches"]["forest_predict"]
    # and every kernel's launches on mesh_main's ranks, K1's on mesh_nccl1's tiles
    for k in ("tps_grid", "tree_grow", "forest_predict", "svm_sweep"):
        launches[k] += mesh["launches"][k]
    launches["tps_grid"] += nccl1["launches"]["tps_grid"]
    k2cv = k2["shapes"]["cv"]
    # no single PyTorch call grows a tree, evaluates a forest or runs a
    # coordinate sweep: library_ms null.
    # tree_grow's times and bound are per tree at the CV shape (a launch on the
    # path grows a cycle of K2_CYCLE trees)
    emit({"kernels": [{
        "name": "tps_grid", "route": "cuda", "source": "machisplin_tpu_torch/csrc/tps_grid.cu",
        "replaces": "machisplin_tpu/ops/pallas_tps.py:56", "launches": launches["tps_grid"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
    }, {
        "name": "tree_grow", "route": "cuda", "source": "machisplin_tpu_torch/csrc/tree_grow.cu",
        "replaces": "machisplin_tpu/ops/pallas_grow.py:69", "launches": launches["tree_grow"],
        "max_abs_err": k2cv["max_abs_err"], "ms": k2cv["ms"], "plain_ms": k2cv["plain_ms"],
        "bound_ms": k2cv["bound_ms"], "bound_by": k2cv["bound_by"], "library_ms": None,
    }, {
        "name": "forest_predict", "route": "cuda", "source": "machisplin_tpu_torch/csrc/forest_predict.cu",
        "replaces": "machisplin_tpu/ops/pallas_forest.py:200", "launches": launches["forest_predict"],
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
    }, {
        # not a Pallas kernel: the JAX package's sweep is a lax.fori_loop (svm.py:134)
        "name": "svm_sweep", "route": "cuda", "source": "machisplin_tpu_torch/csrc/svm_sweep.cu",
        "replaces": "machisplin_tpu/models/svm.py:134", "launches": launches["svm_sweep"],
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], "library_ms": None,
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output", flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
