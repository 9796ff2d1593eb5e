#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``stereo_vo_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device and ``nvcc``.
It needs one card, no network and no arguments, and it imports nothing of
JAX or of the JAX package. Phases, each fatal on failure:

1. device: print the card (``nvidia-smi`` name and power limit) and the
   CUDA version; switch TF32 off; log whether this PyTorch binds CUDA-graph
   conditional nodes (``begin_capture_to_if_node``,
   ``get_currently_capturing_graph``), its CUDA version and the driver's,
   the CUDA runtime's and driver's versions the port's conditional nodes run
   under (nesting needs 12.4), and probe the port's own conditional nodes
   (``csrc/graph_cond.cu`` through ``engine/graphs.py``): an IF on a 0-d
   bool on the card with the body ``x + 1``, captured once and replayed
   with each value, and a WHILE node nested in an IF body, replayed at 3,
   0 and 5 trips and with the IF's bool false; load the
   photo texture the port ships (``data/grace_hopper.jpg``, no matplotlib on
   the card's machine) and print its shape;
2. build: compile the seven CUDA sources, ``stereo_vo_tpu_torch/csrc/
   extract_regions.cu``, ``lk_level.cu``, ``stereo_bm_at.cu``,
   ``greedy_nms.cu``, ``ba_lm.cu``, ``pnp_hyp.cu`` and ``graph_cond.cu``, one nvcc each,
   started together, and print each build's seconds and what ptxas reports;
3. region-extraction kernel check: the kernel against its plain PyTorch
   version (``extract_regions_ref``) at the shapes the main path gives it,
   at a stack over 6 MiB (where the JAX package takes its tiled variant) and
   at the edges of the kernel's work split (one feature, a partly filled
   last block, a partial last task with ``rx % 32 != 0``, two channels, rows
   wider than one pass covers), each from a stack that starts on a 16-byte
   boundary and from one that starts 4 bytes past it, bitwise
   (``torch.equal``: a copy has no rounding); then, at ``TIMED``, the call,
   the plain version and the one PyTorch indexing call that computes the
   same function timed with CUDA events (median of 20 samples), the
   kernel's device time per launch read from ``torch.profiler``, beside the
   bound from the bytes moved, and the call at N = 0 (host side alone);
3b. LK level-pass kernel check: ``lk_level_pass`` against
   ``lk_level_pass_ref`` on frames 0-1 of phase 4's world and their
   detected corners (tiled to N, guesses within +-slack), at ``LK_SHAPES``
   (level 0 and 1 with 56x56 regions, the top level and the hinted top with
   88x88, N = 160 and 448), forward and backward role, within the ``LK_*``
   tolerances, both timed, beside the bound from this run's bytes and
   iterations, and the kernel's device time per launch at the headline shape;
   then the fast-motion sweep of ``tests/test_lk_fast_motion.py``: its scene
   shifted by each of ``FAST_SHIFTS`` (up to 200 px, where the top level's
   guess sits at 25 of ``LK_SLACK_TOP`` = 26 px), ``lk_track_fwdbwd``
   through the kernel against the same call through the plain version: no
   fwd/bwd flag flipped, positions within ``LK_POS_TOL``, the survivors on
   the known shift; and at ``LK_INACTIVE_SHAPES`` every other slot inactive
   (the tracker runs its whole capacity): the inactive slots' outputs
   bitwise the plain version's (the centre bitwise the all-active kernel's
   and within ``LK_CENTER_RTOL`` of the plain one), the active slots
   bitwise the all-active call's, the device time per launch beside the
   all-active one;
3c. sparse StereoBM kernel check: ``stereo_bm_at`` against
   ``stereo_bm_at_ref`` on frames 0-1 of phase 4's world and pairs 0-1 of
   ``tests/fixtures/real``, bitwise (``torch.equal``: uint8 images make
   every SAD an exact f32 integer), at the main path's slot sets
   (``BM_SETS``: the bootstrap's 300 detections at full width; a keyframe's
   748 slots, frame 0's detections then frame 1's standing in for tracked
   inliers, at <= 320 valid, where the plain version compacts, and with
   every slot valid, where it does not; all 748 invalid; none), both timed
   (CUDA events, median of 20 samples), the kernel's device time per call
   read from ``torch.profiler``, beside the bound from this run's bytes and
   operations (no one PyTorch call computes sparse BM: no library time);
3d. greedy-NMS kernel check: ``greedy_nms`` against ``greedy_nms_ref`` (the
   accepted set) and ``greedy_nms_pack_ref`` (detection's cap at 300 and
   pack, in the same launch) on the candidate pools of frames 0-4 of phase
   4's world and of frame 0 of the photo world, on 1024 valid candidates in
   one conflict chain, on none valid, on clusters at the image corners and
   on ``NMS_POOLS`` (seeded pools of 1500 and 4096 candidates at two
   densities, coordinates on the binning's cell borders, a pool wider than
   its grid, non-finite coordinates), bitwise, one launch per call; for each
   set the plain fixpoint's rounds, the kernel's conflict pairs, bit-row
   candidates, grid and SM cycles by phase, the
   packed call timed, the plain version too, the kernel's device time per
   launch from ``torch.profiler``, beside the bound (13 B per candidate and
   per packed row, or one pair test per conflicting pair; no library time);
3e. bundle-adjustment kernel check (``_ba_hold``): ``ba_cost``,
   ``ba_build``, ``ba_damp_reduce`` and ``ba_step`` (``csrc/ba_lm.cu``) on
   the card against their plain versions (``backend/schur.py``) on the CPU
   from the same inputs, on the windows the solves of steps 8-11 of phase
   4's world start from, each compacted and full, within the ``BA_*``
   tolerances; the whole LM loop through the kernels against the plain loop
   (``it`` and accepted steps equal); at the first window each kernel's call
   timed beside its plain version, its device time per launch and its bound
   (``ba_damp_reduce`` also beside its Gram as one ``einsum``);
3f. PnP hypothesis kernel check (``_pnp_hyp_check``): ``pnp_hypotheses``
   (``csrc/pnp_hyp.cu``) on the card against ``pnp_hypotheses_ref`` on the
   CPU, from the inputs of every PnP call of phase 4's world streamed
   eagerly (its accepted frames: 99 samples of 6 of the 448 slots each),
   held by ``eval.parity.hypothesis_hold`` (ok flags equal, ok poses
   within ``PNP_POSE_TOL`` plus ``PNP_SPREAD_FACTOR`` times the
   hypothesis's own one-ulp rounding spread, rounding-decided samples
   counted), and before the polish bitwise the kernel's arithmetic built
   for the host (``pnp_hypotheses_host``); at the first call the kernel's
   call and the plain version's (torch ops on the card) timed, the
   kernel's device time per launch and its bound;
4. main path: ``run_vo`` over a 20-frame synthetic KITTI-sized world
   (376x1241, ``kitti00`` intrinsics, default capacities) on ``cuda``, with
   the kernels' launch counters zeroed just before and read just after; it
   checks the poses (20, finite), at least 2 keyframes after bootstrap, the
   median tracked count over the steps (> 50), PnP on every accepted frame,
   exactly one ``lk_level_pass`` launch per LK level pass (forward plus
   backward), exactly one ``stereo_bm_at`` and one ``greedy_nms`` launch per
   keyframe (bootstrap included), no ``extract_regions`` launch, per solve
   one ``ba_cost`` and ``1 + accepted`` ``ba_build`` launches and as many
   ``ba_damp_reduce`` as ``ba_step`` launches, one ``pnp_hypotheses``
   launch per PnP body (per accepted frame: a keyframe, or a frame whose
   PnP failed), and the aligned keyframe ATE; the whole step runs as one CUDA graph whose
   decisions are conditional nodes (the engine's default on the card) here
   and in every later phase; then (4b), in a child process (a long
   process's profiler drops kernels of the graph's conditional bodies; 4d
   and 6b run in their own too), ``utils.profiling.profile_keyframes``
   streams the same world and profiles
   steps 8-11: kernel and graph launches, syncs and device ms per keyframe
   step, each kernel's launches in the device trace equal to its wrapper's
   count, each step (with its summary fetch) one graph launch, no kernel
   launch and at most ``STEP_SYNCS_MAX`` syncs, step p50, the device kernels
   per keyframe step; the device kernels of one greedy detection on frame 0
   with the cap and pack in the NMS kernel against the same with them as
   torch ops (fewer, outputs bitwise equal); then the
   Shi-Tomasi response on frame 0 of the photo world (phase 5b's): the pixels
   where the card's differs from the CPU's (want 0, single image and a stack
   of three), and its device time per frame beside the former formula's;
4c. the card held to the reference: phase 4's run, frame by frame, against
   the JAX package's run of the same world stored in
   ``tests/fixtures/jax_reference/kitti00_w20.npz``
   (``tests/fixtures/make_jax_reference.py``): ``is_keyframe`` and
   ``pnp_ok`` identical on every frame, ``num_tracked`` and ``num_inliers``
   within ``COUNT_TOL`` (what the CPU test allows: equal), the pose within
   ``TRAJ_TOL_CARD``; per-frame max |dq|, |dt| and integer differences are
   printed. Then ``sample_hypotheses`` on ``cuda``, under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises), on
   the stored valid masks of ``pnp_draws.npz``: the stored JAX indices,
   bitwise; and its host ms per draw; then ``GEOMETRIES``: the billboard
   world's 12 frames at ``kitti03`` (375x1242), ``d435i`` (480x640),
   ``kitti08`` (370x1226) and ``multisense`` (801x801), each through its own
   step graph, held to ``kitti03_w12.npz`` and ``kitti08_w12.npz`` as above
   and to ``d435i_w12.npz`` and ``multisense_w12.npz`` by the divergence
   rule (their references' nudged reruns part; ``multisense``'s keyframe
   ATE band printed, not held: ``GEOMETRY_ATE_UNHELD``), poses within
   ``GEOMETRY_TRAJ_TOL``, launches exact, and each bitwise equal to the same
   world run eagerly;
4d. graphs against eager, in a child process: the same 20 frames streamed
   by an engine with ``graphs=True`` and one with ``graphs=False``: every
   summary (pose included) and the final state bitwise equal; steps 8-19 of
   the graph run profiled: each step one graph launch, no kernel launch and at most
   ``STEP_SYNCS_MAX`` syncs with its summary fetch, each kernel's launches
   in the trace equal to its wrapper's count, one BM and one NMS launch per
   keyframe; a WHILE node (the LM loop) in the keyframe solve's body and IF
   pairs (its rebuilds) in that; on the windows of steps 8-11, each solve
   as a graph of its own at the default ``max_lm_iters`` within
   ``SOLVE_CUT_RTOL`` (or ``SOLVE_CUT_ATOL_MS``) of its device time cut to
   its own ``it``, and, counted on the device in the step graph, the WHILE
   node's trips equal to ``ceil(it / 2)`` and the builds to ``1 +
   accepted``, each BA kernel's launches exact per solve; in a child
   process the same steps run eagerly, their device time split into
   detection, BM, PnP and BA (``utils.profiling.profile_step_parts``);
   then the 129-frame world of
   phase 5 chunked by 64 with preload, graph against eager: every summary
   and the final state bitwise equal; and one profiled ``replay_chunk`` of
   64 frames (``utils.profiling.profile_chunk``): at most
   ``CHUNK_SYNCS_MAX`` syncs inside it and one graph launch per frame;
5. chunked replay with preload: ``run_vo(chunk_size=64, preload_device=True,
   checkpoint_every=65, out_dir=...)`` on ``cuda`` over the bench's
   129-frame world (bootstrap + two chunks of 64; same parameters as
   phase 4); it checks 129 finite poses, no preload miss, hint engagement,
   the keyframe count over frames 49-64, the aligned keyframe ATE, 129
   ``metrics.jsonl`` rows and the launches as in phase 4, and holds the run
   to ``kitti00_w129_c64.npz`` as phase 4c does, within
   ``REPLAY_TRAJ_TOL_CARD``;
5b. the photo-textured long-horizon world (``tests/test_long_sequence.py``'s:
   161 frames of 376x1241, the photograph as texture, 3000 points, seeds 11
   and 23): ``run_vo(chunk_size=32, preload_device=True)`` on ``cuda``, the
   launches as in phase 4, at least ``PHOTO_MIN_KEYFRAMES`` keyframes, held
   to ``kitti00_photo_s{seed}_w161_c32.npz`` by the divergence rule of
   ``tests/test_torch_long_horizon.py``: per-frame differences printed, the
   frames held exactly, the first departure with what departed and the
   nudged reference reruns' departure there, keyframes and the aligned
   keyframe ATE beside the reference runs';
6. resume: ``run_vo(resume_from=<phase 5's checkpoint>, chunk_size=64)``
   over the same frames gives exactly frames 65-128, finite, the first
   within ``RESUME_TOL`` of phase 5's pose for frame 65, launches as in
   phase 4; then (6b), in a child process,
   ``utils.profiling.profile_replay`` streams frames 0-80 of that world and
   profiles frames 65-72: launches, syncs and device
   ms per frame and per cruise and keyframe step (the device's busy share of
   a cruise step), each step one graph launch with at most
   ``STEP_SYNCS_MAX`` syncs, the LK kernel's launches in the device trace,
   step and ``track_step`` p50;
7. the CLI on real imagery: a child process runs
   ``python -m stereo_vo_tpu_torch.cli run`` on ``tests/fixtures/real``
   (5 KITTI-layout 376x1241 pairs with ground truth) on ``cuda``, with cv2,
   PIL and matplotlib made unimportable in it, so PNGs decode through
   ``native/`` and track images are drawn with numpy and saved as ``.npy``;
   it checks the exit code, the JSON summary (5 frames, ATE rmse under
   2.5 m), and every output file; a second child checks that ``--plot``
   without matplotlib fails with a clear error;
8. single-device options on ``cuda`` at 376x1241 (``kitti00``, default
   capacities): (a) the dense StereoBM on pair 0 of ``tests/fixtures/real``
   and on frame 0 of phase 4's world, sampled at the detected corners, must
   equal the sparse ``stereo_bm_at`` (its kernel) there (validity
   identical, values within ``BM_TOL``), and ``triangulate_features`` on the
   dense map must give the sparse path's points there (validity identical,
   within ``TRI_RTOL``); (b) forward-only tracking
   (``track_step(flow_back=False)``) over phase 4's 19 consecutive pairs,
   each from a fresh ``tracker_init`` on frame t's detections: exactly one
   ``lk_level_pass`` launch per pyramid level per pair, a median tracked count
   over 50, kept counts and ms beside the fwd/bwd path's on the same pairs;
   (c) maxpool detection gives 0.3-1.0 x the greedy count, its corners
   pairwise at least ``min_distance`` apart; (d) ``run_vo`` over phase 4's
   world with a YAML that sets ``backend: reduced_solve_f64: true``, loaded
   by ``load_config(path)``: aligned keyframe ATE under phase 4's bound, the
   max pose difference from phase 4 and ``reduced_camera_condition`` of the
   last window;
9. the landmark-sharded BA: (a) a world of one NCCL rank on ``cuda:0``
   (file store in a temporary directory): ``sharded_bundle_adjust`` equals
   ``bundle_adjust`` on a 5 x 2048 window; (b) ``dryrun_multichip(4,
   "cuda")``: four gloo ranks on ``cuda:0`` with tensors on the card (NCCL
   refuses two ranks on one card) run the dp x lm batch and the 5 x 2048 and
   32 x 16384 solves, sharded == single, with LM iterations/s per shard
   count.

Launch counts are zeroed just before, and read just after, each of phases
4-6 (5b once per seed) and 8b (phase 7's launches happen in a child process and are not
counted). The line before the last is the kernels' JSON record, with
launches summed over phases 4-6 and 8b, the headline shape's times
(extraction: 160 regions of 56x56 at level 0; LK: the level-0 forward pass,
56x56, N = 160; sparse BM: the 748-slot keyframe input at <= 320 valid on
the synthetic frame; greedy NMS: frame 0's candidate pool, the fixpoint
with the cap and pack at 300), each call's
time and its kernel's device time per launch, and bounds; the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device, or without the package beside it,
the script exits non-zero before printing any result.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# aligned keyframe ATE bound (m): twice what the port gave for the same 20
# frames on the CPU before it drew the reference's PnP samples (rmse 0.0784
# m, PyTorch 2.13 CPU build); with them it gives the reference's 0.0808 m
ATE_BOUND_M = 0.1568
# phases 4c and 5: the JAX package's runs of the same worlds, frame by frame
REF_DIR = os.path.join("tests", "fixtures", "jax_reference")
# pose |difference| from the reference (quaternion units and metres): twice
# the largest measured on an H100 (700 W), 3.23e-6 over the 20 frames; over
# the 129 frames 5.11e-4 was measured (one more LM iteration than the
# reference at frame 25, as on the CPU), so the 1e-3 cap holds there
TRAJ_TOL_CARD = 6.5e-6
REPLAY_TRAJ_TOL_CARD = 1e-3
# num_tracked / num_inliers difference from the reference (the CPU test: 0)
COUNT_TOL = 0
# phase 5b: the photo-textured long-horizon world (tests/test_long_sequence.py,
# stored JAX runs with their nudged reruns in REF_DIR), held by the divergence
# rule of tests/test_torch_long_horizon.py (eval/parity.py::divergence_hold):
# exact up to the first departure, which may come no earlier than the nudged
# reference reruns' first and lie within SPREAD_FACTOR times their departure
# there; then keyframes within the reference runs' range and the aligned
# keyframe ATE within ATE_RTOL of theirs. The pose tolerance of the exact part
# is twice the largest measured on an H100 (700 W) before the first departure
PHOTO_SEEDS = (11, 23)
PHOTO_CHUNK = 32
PHOTO_WORLD = dict(n_frames=161, n_points=3000, speed=0.9, yaw_rate=0.004)
TRAJ_TOL_PHOTO_CARD = 9.5e-6
PHOTO_BA_RTOL = 1e-3
SPREAD_FACTOR = 2.0
ATE_RTOL = 0.10
PHOTO_MIN_KEYFRAMES = 30
N_FRAMES = 20
IMAGE_SHAPE = (376, 1241)
# phases 5-6: the bench's world (bench.py: 1 + 2 chunks of 64), its chunk
# size, and a checkpoint that lands on the first chunk boundary (frame 65).
# Bounds are wide around what the port gave on the same world on an H100 in
# streaming mode: keyframes 5 of 16 over frames 49-64, the hinted short
# pyramid on 112 of 128 steps (0.875), aligned keyframe ATE 0.057 m.
N_REPLAY = 129
CHUNK = 64
CKPT_EVERY = 65
KF_WINDOW = (49, 65)            # frames 49..64
KF_WINDOW_RANGE = (3, 7)
HINT_MIN = 0.5
REPLAY_ATE_BOUND_M = 0.2
# resumed vs straight pose at frame 65: not bitwise on the card, since CUDA
# scatter-adds are atomic and their summation order varies
RESUME_TOL = 1e-3
# phase 7: the JAX package's bound for the same fixtures
# (tests/test_real_fixtures.py::test_full_pipeline_on_real_fixtures)
REAL_ATE_BOUND_M = 2.5
REAL_ROOT = os.path.join("tests", "fixtures")
REAL_SEQUENCE = "real"
REAL_CONFIG = "kitti00"
REAL_FRAMES = 5
HIDE_HOST_LIBS = (
    "import runpy, sys\n"
    "for m in ('cv2', 'PIL', 'matplotlib'):\n"
    "    sys.modules[m] = None\n"
    "sys.argv[0] = 'stereo_vo_tpu_torch.cli'\n"
    "runpy.run_module('stereo_vo_tpu_torch.cli', run_name='__main__')\n"
)

# (label, channels, padded image H, W, region rows, cols, features): LK inner
# levels (56x56, pad 22) and the top level (88x88, pad 38) at the compacted
# (160) and full (448) widths; the BM left window (32x32) and right search
# band (32x80, pad 66) at the compacted (320) and full widths; the JAX
# package's own extraction-test shapes; a 1280x1280 level (6.25 MiB, over
# the 6 MiB where the JAX dispatcher takes _extract_regions_tiled); and the
# edges of the kernel's work split (csrc/extract_regions.cu): one feature, a
# last block of warps left partly empty (161 x 14 four-row tasks), a partial
# last task (30 rows) with rx % 32 != 0, two channels, and rows of 160
# columns, wider than a lane's four 32-column chunks (two passes)
SHAPES = [
    ("lk_l0_56_n160", 1, 376 + 44, 1241 + 44, 56, 56, 160),
    ("lk_l0_56_n448", 1, 376 + 44, 1241 + 44, 56, 56, 448),
    ("lk_l1_56_n160", 1, 188 + 44, 621 + 44, 56, 56, 160),
    ("lk_top_88_n160", 1, 47 + 76, 156 + 76, 88, 88, 160),
    ("lk_top_88_n448", 1, 47 + 76, 156 + 76, 88, 88, 448),
    ("lk_hint_top_88_n160", 1, 188 + 76, 621 + 76, 88, 88, 160),
    ("bm_left_32x32_n320", 1, 376 + 132, 1241 + 132, 32, 32, 320),
    ("bm_right_32x80_n320", 1, 376 + 132, 1241 + 132, 32, 80, 320),
    ("bm_left_32x32_n768", 1, 376 + 132, 1241 + 132, 32, 32, 768),
    ("bm_right_32x80_n768", 1, 376 + 132, 1241 + 132, 32, 80, 768),
    ("img_384x1256_r88", 1, 384, 1256, 88, 88, 64),
    ("img_96x320_r48", 1, 96, 320, 48, 48, 64),
    ("tiled_1280x1280_r88_n64", 1, 1280, 1280, 88, 88, 64),
    ("edge_56_n1", 1, 376 + 44, 1241 + 44, 56, 56, 1),
    ("edge_56_n161", 1, 376 + 44, 1241 + 44, 56, 56, 161),
    ("edge_30x57_n33", 1, 376 + 44, 1241 + 44, 30, 57, 33),
    ("edge_c2_16x24_n40", 2, 64, 96, 16, 24, 40),
    ("edge_c2_56_n160", 2, 188 + 44, 621 + 44, 56, 56, 160),
    ("edge_16x160_n32", 1, 376 + 44, 1241 + 44, 16, 160, 32),
]
# phase 3: every shape is checked from a stack at each of these offsets, in
# floats, past a 16-byte boundary (the kernel assumes no alignment of rows)
STACK_OFFSETS = (0, 1)
# phase 8: dense vs sparse BM at the corners (both sum exact integers), and
# the points triangulated from each (relative to max(|p|, 1))
BM_TOL = 1e-5
TRI_RTOL = 1e-4
MAXPOOL_RANGE = (0.3, 1.0)
# phase 9: sharded vs single device, the JAX dry run's bounds
SHARD_POSE_TOL = 2e-4
SHARD_LM_TOL = 2e-3
# phase 3's timed shapes: the main path's, and one region alone (the floor
# of any call's device time)
TIMED = ("lk_l0_56_n160", "lk_l0_56_n448", "lk_top_88_n160", "bm_left_32x32_n320",
         "bm_right_32x80_n320", "edge_56_n1")
HEADLINE = "lk_l0_56_n160"
# phase 3b: the LK level pass at the main path's shapes, (label, pyramid level
# of the 376x1241 frames, top-level slack?, features): level 0 and level 1
# (56x56 regions), the 47x156 top level and the 188x621 top of the hinted
# two-level pyramid (88x88), at the compacted and the full width
LK_SHAPES = [
    ("l0_56_n160", 0, False, 160), ("l0_56_n448", 0, False, 448),
    ("l1_56_n160", 1, False, 160), ("l1_56_n448", 1, False, 448),
    ("top_88_n160", 3, True, 160), ("top_88_n448", 3, True, 448),
    ("hint_top_88_n160", 1, True, 160), ("hint_top_88_n448", 1, True, 448),
]
LK_HEADLINE = "l0_56_n160 forward"
# kernel vs plain version of one level pass. The 441-term Gram and GN sums and
# the region mean add in another order, which can flip an eps or oscillation
# test at its margin: a flipped feature takes one iteration more or fewer and
# moves by up to ~eps = 0.01 px. solvable flips only with min_eig exactly at
# its threshold.
LK_SOLVABLE_FLIPS = 1           # per call
LK_OK_SHARE = 0.995             # final ok equal on this share of active features
LK_POS_TOL = 0.02               # px, features ok in both
LK_POS_MEDIAN_TOL = 1e-4        # px, median over features ok in both
LK_CENTER_RTOL = 1e-4           # relative to max(|c|, 1)
# phase 3b, fast motion: tests/test_lk_fast_motion.py's shifts (px), up to the
# reference's 200 px parallax limit; the kernel path against the plain path,
# no fwd/bwd flag flipped
FAST_SHIFTS = (40, 100, 160, 200)
# phase 3c: the sparse-BM slot sets, and the headline (pair, set)
BM_SETS = ("bootstrap_n300", "keyframe_n748_le320", "keyframe_n748_all_valid",
           "all_invalid_n748", "empty_n0")
BM_HEADLINE = "synthetic keyframe_n748_le320"
# phase 3d: the headline greedy-NMS set (frame 0's candidate pool), and the
# seeded pools beside the frames' (_nms_pool): over 1024 candidates at two
# densities (the dense 4096 overflows the kernel's shared lists into bit
# rows), the binning's cell borders, a grid that grows, non-finite values
NMS_HEADLINE = "billboard0"
NMS_POOLS = ("random1500_sparse", "random1500_dense", "random4096_sparse", "random4096_dense",
             "cell_borders", "wide", "nonfinite")
# phases 4b, 4d and 6b: host syncs allowed per streamed step (the step is one
# graph launch with no read; the summary fetch is the one wait) and inside
# replay_chunk, between its first frame and its last (none), and the steps
# phase 4d profiles
STEP_SYNCS_MAX = 1
CHUNK_SYNCS_MAX = 0
GRAPH_PROFILED = (8, 20)
# phase 4d: a solve at the default max_lm_iters against the same solve cut to
# its own it (no body runs after done), device ms
SOLVE_CUT_RTOL = 0.05
SOLVE_CUT_ATOL_MS = 0.1
# phase 4c: the other shipped geometries through their own step graphs, each
# held to its stored JAX run by the rule the CPU tests hold it to
# (tests/test_torch_trajectory.py): kitti03 and kitti08 frame by frame, d435i
# and multisense (whose references' nudged reruns part from them) by the
# divergence rule; the pose
# tolerance is those tests' TRAJ_TOL
GEOMETRIES = (("kitti03", "kitti03_w12.npz"), ("d435i", "d435i_w12.npz"),
              ("kitti08", "kitti08_w12.npz"), ("multisense", "multisense_w12.npz"))
GEOMETRY_TRAJ_TOL = 1e-4
# phase 4c: the geometry whose card run departs where its reference's reruns
# do, with their keyframes, but whose keyframe ATE after the departure lies
# below the four reference runs' band (0.0408 m against 0.0467-0.0665 on the
# H100; the CPU's run lies inside it): that part of the rule is printed, not
# held (PERF.md §7)
GEOMETRY_ATE_UNHELD = ("multisense",)
# phase 3e: the BA kernels on the card against their plain versions on the
# CPU (where the tests hold them to the JAX package), from the same inputs,
# on the windows the bundle adjustments of steps BA_STEPS of phase 4's world
# start from, each compacted and full: per-landmark outputs within BA_LM_TOL
# (a build's: and BA_HUBER_ULPS of its Huber weights' amplification) of each
# block's largest magnitude (a landmark's block: all that the kernel writes
# for it, e.g. a build's v, g_l and W couplings, since g_l = -J^T r carries
# the rounding of residuals that cancel to near zero; for a step, the new
# position and the products its back-substitution sums), landmark-summed
# ones within BA_SUM_RTOL of the largest magnitude of the sum and of the pose
# blocks it is formed from (the pose gradient: of the Cauchy-Schwarz bound on
# its terms), integers and flags equal; the whole solve through the kernels
# against the same solve through the plain versions on the CPU: it and
# accepted equal, poses within BA_POSE_TOL. The headline is the first window
# at its own compaction choice.
BA_STEPS = range(8, 12)
# phases 4b and 4d: the kernels of the LM loop's WHILE body, which runs in
# the solve's IF body. In 4b's fresh process torch.profiler names a nested
# WHILE body's kernels on its first trip only (on an H100: 8 ba_step
# launches in the trace of steps 8-11, 24 counted on the device, their LM
# loops taking 5 + 2 + 3 + 2 trips), so the trace holds between one and all
# of these launches; every other kernel's launches in the trace equal its
# wrapper's count
LOOP_KERNELS = ("ba_build_kernel", "ba_damp_reduce_kernel", "ba_step_kernel")
BA_LM_TOL = 1e-6
# a build's landmark blocks carry their observations' Huber weights, delta /
# |r| where |r| > delta: a projection rounded a few ulps otherwise moves |r|
# by that much, and the weight by (ulps * |uv| * 2^-24) / |r| relative; so a
# landmark's build error may also reach BA_HUBER_ULPS of that amplification
# (|uv| / |r| over its observations in the Huber tail)
BA_HUBER_ULPS = 4
BA_SUM_RTOL = 1e-5
BA_POSE_TOL = 1e-5
# f32 operations the BA kernels need (their bounds): per masked-in
# observation of a build (Jacobians, Huber weight, lift, Gram rows and
# sums), per active landmark of a damped reduction besides its Gram (damped
# inverse, wlg V^-1), per Gram entry and landmark (three products, three
# sums), per landmark of a step besides its costs (back-substitution,
# predicted decrease), per masked-in observation of a cost
BA_BUILD_OPS_PER_OBS = 540
BA_DAMP_OPS_PER_LM = 60
BA_GRAM_OPS = 6
BA_STEP_OPS_PER_LM = 40
BA_COST_OPS_PER_OBS = 45
# phase 3f: the PnP hypothesis kernel on the card against its plain version
# on the CPU: tests/test_torch_pnp.py's rule (POSE_TOL, SPREAD_FACTOR), the
# pose tolerance of the PnP parity tests plus 4 times the hypothesis's own
# one-ulp rounding spread (the card's sin and cos and the CPU's LAPACK sum
# order part the two by rounding, and rounding decides an ill-conditioned
# sample), and at most PNP_DECIDED_MAX of the hypotheses decided by rounding
# (samples with outliers: the polish cannot fit them)
PNP_POSE_TOL = 1e-4
PNP_SPREAD_FACTOR = 4.0
PNP_DECIDED_MAX = 0.6
# f32 operations of one hypothesis (its bound), counted from the kernel's
# loops: the DLT (Householder QR 3,600, the ridge's scale 290, inverse
# iteration 650, Q z 390, the polar fix of both signs 1,200, the rest 270),
# and each polish iteration (12 Jacobian rows 2,760, J^T J and -J^T r
# 1,010, the LU solve and the retraction 280)
PNP_DLT_OPS = 6400
PNP_POLISH_OPS = 4050
# bytes a hypothesis reads (6 int64 indices, 6 points and pixels) and writes
PNP_BYTES_PER_HYP = 48 + 6 * 20 + 29
# phase 3b: the level pass with every other slot inactive (the tracker's
# capacity at full width), at these of LK_SHAPES
LK_INACTIVE_SHAPES = ("l0_56_n160", "l0_56_n448")
# the card's published rates (H100 SXM): HBM bytes/s and f32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def _log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def _phase(name: str) -> None:
    """Log the start of a phase with the seconds since the script began."""
    _log(f"phase {name} at {time.perf_counter() - _START:.1f} s")


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _nvidia_smi(query="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _conditional_probe(torch, dev) -> dict:
    """Phase 1: whether this PyTorch binds CUDA-graph conditional nodes, the
    CUDA versions the port's own run under, and the port's own
    (``csrc/graph_cond.cu`` through ``engine/graphs.py``): an IF on a 0-d
    bool on the card whose body is ``x + 1``, captured once and replayed
    once with each value of the bool; and a WHILE node inside an IF body
    (``x`` plus one per trip), replayed at 3, 0 and 5 trips with the bool
    true and at 5 with it false."""
    from stereo_vo_tpu_torch.engine import graphs

    bound = {name: hasattr(torch.cuda.CUDAGraph, name)
             for name in ("begin_capture_to_if_node", "end_capture_to_conditional_node",
                          "get_currently_capturing_graph")}
    x = torch.zeros((), dtype=torch.float32, device=dev)

    def body(carry, inputs):
        (x,), (pred,) = carry, inputs
        return (graphs.cond(pred, lambda v: v + 1, lambda v: v, (x,)),), ()

    program = graphs.Program("probe", body)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    carry, _ = program((x,), (flag,))               # eager, then the capture
    seen = []
    for value in (True, False):
        flag.fill_(value)
        carry, _ = program(carry, (flag,))
        seen.append(float(carry[0]))

    def count_up(v, n):
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return graphs.while_loop(lambda c: c[1] < n, lambda c: (c[0] + 1, c[1] + 1),
                                 (v, zero))[0]

    def nested(carry, inputs):
        (x,), (pred, n) = carry, inputs
        return (graphs.cond(pred, count_up, lambda v, _: v, (x, n)),), ()

    program = graphs.Program("probe_while", nested)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    program((x,), (flag, n))
    looped = []
    for value, trips in ((True, 3), (True, 0), (True, 5), (False, 5)):
        flag.fill_(value)
        n.fill_(trips)
        looped.append(float(program((torch.zeros_like(x),), (flag, n))[0][0]))
    program.flush_launches()
    lib = graphs.cond_lib()
    out = {"torch_binds": bound, "torch_cuda": torch.version.cuda,
           "cuda_runtime": lib.runtime, "cuda_driver": lib.driver,
           "driver": _nvidia_smi("driver_version"),
           "port_if_node": {"replayed": seen, "want": [1.0, 1.0]},
           "port_while_in_if": {"replayed": looped, "want": [3.0, 0.0, 5.0, 0.0],
                                "trips": program.runs.get("while:<lambda>"), "want_trips": 8}}
    _log("conditional nodes: " + json.dumps(out))
    _check(seen == [1.0, 1.0], f"the IF node ran its body only when its bool held: {seen}")
    _check(looped == [3.0, 0.0, 5.0, 0.0] and out["port_while_in_if"]["trips"] == 8,
           f"the WHILE node in an IF body ran its trips: {out['port_while_in_if']}")
    return out


def _inputs(torch, gen, c, hp, wp, ry, rx, n, device):
    """A random stack and origins: both image corners, origins past each edge
    (the clamp pulls them in), the rest 8-aligned like the callers' or not."""
    stack = torch.rand((c, hp, wp), generator=gen, device="cpu") * 255.0
    ox = torch.randint(0, wp - rx + 1, (n,), generator=gen)
    oy = torch.randint(0, hp - ry + 1, (n,), generator=gen)
    ox[n // 2:] = ox[n // 2:] // 8 * 8
    oy[n // 2:] = oy[n // 2:] // 8 * 8
    edges = [(0, 0), (wp - rx, hp - ry), (wp - rx + 9, hp - ry + 5), (-5, -11)]
    for i, (x, y) in enumerate(edges[:n]):
        ox[i], oy[i] = x, y
    origins = torch.stack([ox, oy], dim=1).to(torch.int32)
    return stack.to(device).contiguous(), origins.to(device).contiguous()


def _offset_copy(torch, stack, offset):
    """``stack`` copied into a contiguous tensor that starts ``offset``
    floats past the start of its (16-byte aligned) storage."""
    flat = torch.empty(offset + stack.numel(), dtype=stack.dtype, device=stack.device)
    return flat[offset:].view(stack.shape).copy_(stack)


def _lk_passes(cfg, steps) -> int:
    """LK level passes over stepped frames, forward plus backward: the hinted
    short pyramid runs ``lk_hint_levels`` levels forward, a full pass
    ``lk_max_level + 1``; the backward pass runs the finest ``lk_bwd_levels``
    of them (all when that is 0)."""
    fc = cfg.frontend

    def passes(levels):
        return levels + (min(fc.lk_bwd_levels, levels) if fc.lk_bwd_levels > 0 else levels)

    return sum(passes(fc.lk_hint_levels if s["hinted"] else fc.lk_max_level + 1)
               for s in steps)


def _wrappers() -> dict:
    """Each hand kernel's wrapper, by the name the kernels line gives it."""
    from stereo_vo_tpu_torch.backend.schur import ba_build, ba_cost, ba_damp_reduce, ba_step
    from stereo_vo_tpu_torch.frontend.pnp import pnp_hypotheses
    from stereo_vo_tpu_torch.ops.lk import lk_level_pass
    from stereo_vo_tpu_torch.ops.regions import extract_regions
    from stereo_vo_tpu_torch.ops.shi_tomasi import greedy_nms
    from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at

    return {"lk_level_pass": lk_level_pass, "stereo_bm_at": stereo_bm_at,
            "extract_regions": extract_regions, "greedy_nms": greedy_nms,
            "ba_build": ba_build, "ba_damp_reduce": ba_damp_reduce, "ba_step": ba_step,
            "ba_cost": ba_cost, "pnp_hypotheses": pnp_hypotheses}


def _zero_launches() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def _launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _wrappers().items()}


def _check_launches(what, launches, lk_want, keyframes, steps=()) -> None:
    """One kernel launch per LK level pass, one sparse-BM and one greedy-NMS
    launch per keyframe and no region extraction, exactly; and per bundle
    adjustment (a keyframe among ``steps``, the frames after a run's
    bootstrap) one ``ba_cost`` launch and ``1 + accepted`` ``ba_build``
    launches, and as many ``ba_damp_reduce`` as ``ba_step`` launches, two a
    trip of its LM loop (exactly per solve in phase 4d); and one
    ``pnp_hypotheses`` launch per PnP body among ``steps`` (an accepted
    frame: a keyframe, or a frame whose PnP failed)."""
    lk, bm, er = launches["lk_level_pass"], launches["stereo_bm_at"], launches["extract_regions"]
    nms = launches["greedy_nms"]
    solves = sum(bool(s["is_keyframe"]) for s in steps)
    accepted = sum(int(s["ba_iterations"]) for s in steps if s["is_keyframe"])
    ba = {k: launches[k] for k in ("ba_cost", "ba_build", "ba_damp_reduce", "ba_step")}
    pnp = launches["pnp_hypotheses"]
    bodies = sum(bool(s["is_keyframe"]) or not s["pnp_ok"] for s in steps)
    _log(f"{what}: lk_level_pass launches {lk} for {lk_want} LK level passes, "
         f"stereo_bm_at launches {bm} and greedy_nms launches {nms} for {keyframes} keyframes, "
         f"extract_regions launches {er}; {json.dumps(ba)} for {solves} solves with "
         f"{accepted} accepted steps; pnp_hypotheses launches {pnp} for {bodies} PnP bodies")
    _check(pnp == bodies, f"{what}: {pnp} pnp_hypotheses launches for {bodies} PnP bodies")
    _check(lk == lk_want > 0, f"{what}: {lk} lk_level_pass launches for {lk_want} passes")
    _check(bm == keyframes, f"{what}: {bm} stereo_bm_at launches for {keyframes} keyframes")
    _check(nms == keyframes, f"{what}: {nms} greedy_nms launches for {keyframes} keyframes")
    _check(er == 0, f"{what}: {er} extract_regions launches")
    _check(ba["ba_cost"] == solves and ba["ba_build"] == solves + accepted
           and ba["ba_damp_reduce"] == ba["ba_step"] and ba["ba_step"] % 2 == 0
           and ba["ba_step"] >= 2 * solves,
           f"{what}: BA launches {ba} for {solves} solves with {accepted} accepted steps")


def _bound_ms(nbytes: float, flops: float):
    """The least time the card could take: bytes over HBM bandwidth or f32
    operations over the f32 peak, whichever is longer, and which it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _distinct_pixels(torch, origins, m, h, w, ry, rx) -> int:
    """Distinct pixels of an [h, w] image that regions at ``origins`` (in
    coordinates padded by ``m``, edge-replicated) read."""
    mask = torch.zeros((h, w), dtype=torch.bool, device=origins.device)
    o = origins.to(torch.int64)
    rows = (o[:, 1:2] - m + torch.arange(ry, device=o.device)).clamp(0, h - 1)
    cols = (o[:, 0:1] - m + torch.arange(rx, device=o.device)).clamp(0, w - 1)
    mask[rows[:, :, None], cols[:, None, :]] = True
    return int(mask.sum())


def _build_all(cuda_build, names) -> None:
    """Phase 2: one nvcc per source, all started together."""
    import threading

    errors = []

    def build(name):
        try:
            cuda_build.build(name)
        except RuntimeError as e:       # nvcc failed: reported below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(name,)) for name in names]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _check(not errors, f"build: {errors}")
    for name in names:
        cuda_build.load(name)
        _log(f"build: {name}.cu nvcc {cuda_build.build_seconds.get(name, 0.0):.2f} s")
        for line in cuda_build.build_log.get(name, "").splitlines():
            _log(f"  ptxas: {line.strip()}")
    _log(f"build: {len(names)} libraries in {time.perf_counter() - t0:.2f} s")


def _extraction_times(torch, extract_regions, stack, origins, ry, rx):
    """One ``extract_regions`` call's time in ms (CUDA events) and its
    kernel's device time per call in us (``torch.profiler``)."""
    call = lambda: extract_regions(stack, origins, ry, rx)
    return (_time_ms(torch, call),
            _device_us(torch, call, "extract_regions_kernel", extract_regions))


def _extraction_check(torch, dev):
    """Phase 3: ``extract_regions`` against ``extract_regions_ref`` at
    ``SHAPES`` from stacks at ``STACK_OFFSETS``, timed at ``TIMED``, and the
    call at N = 0; returns the largest difference and the timed records."""
    from stereo_vo_tpu_torch.ops.regions import extract_regions, extract_regions_ref

    gen = torch.Generator(device="cpu").manual_seed(0)
    max_err, timings = 0.0, {}
    for label, c, hp, wp, ry, rx, n in SHAPES:
        stack, origins = _inputs(torch, gen, c, hp, wp, ry, rx, n, dev)
        want = extract_regions_ref(stack, origins, ry, rx)
        for offset in STACK_OFFSETS:
            before = extract_regions.launches
            got = extract_regions(_offset_copy(torch, stack, offset), origins, ry, rx)
            torch.cuda.synchronize()
            _check(extract_regions.launches == before + 1, f"one launch at {label}")
            _check(got.shape == (n, c, ry, rx) and torch.equal(got, want),
                   f"kernel equals the plain version at {label}, stack offset {offset}")
            max_err = max(max_err, float((got - want).abs().max()))
        _log(f"check {label}: [{n}, {c}, {ry}, {rx}] from [{c}, {hp}, {wp}], stack offsets "
             f"{list(STACK_OFFSETS)} floats: bitwise equal")
        if label == HEADLINE:
            head = (stack, origins, ry, rx)
        if label not in TIMED:
            continue
        # the one PyTorch call that computes the same function for C = 1, on
        # starts placed beforehand: advanced indexing
        o = origins.long()
        ox = torch.where(o[:, 0] < 0, o[:, 0] + wp, o[:, 0]).clamp(0, wp - rx)
        oy = torch.where(o[:, 1] < 0, o[:, 1] + hp, o[:, 1]).clamp(0, hp - ry)
        rows = oy[:, None] + torch.arange(ry, device=dev)
        cols = ox[:, None] + torch.arange(rx, device=dev)
        k_ms, dev_us = _extraction_times(torch, extract_regions, stack, origins, ry, rx)
        p_ms = _time_ms(torch, lambda: extract_regions_ref(stack, origins, ry, rx))
        l_ms = _time_ms(torch, lambda: stack[:, rows[:, :, None], cols[:, None, :]])
        _check(torch.equal(stack[:, rows[:, :, None], cols[:, None, :]].permute(1, 0, 2, 3),
                           want), f"the library call equals the kernel at {label}")
        placed = torch.stack([ox, oy], dim=1)
        nbytes = 4 * (_distinct_pixels(torch, placed, 0, hp, wp, ry, rx) + n * ry * rx) + 8 * n
        bound, bound_by = _bound_ms(nbytes, 0.0)
        timings[label] = {"ms": k_ms, "device_ms": dev_us / 1e3, "plain_ms": p_ms,
                          "library_ms": l_ms, "bound_ms": bound, "bound_by": bound_by}
        _log(f"time {label}: call {k_ms * 1e3:.1f} us ({dev_us:.2f} us of it on the device, "
             f"{nbytes / 1e3 / dev_us:.1f} GB/s), plain {p_ms * 1e3:.1f} us, library "
             f"{l_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({bound_by}: "
             f"{nbytes / 1e6:.2f} MB; device time / bound {dev_us / (bound * 1e3):.2f})")
    # the call's host side alone: no feature, so no launch
    stack, origins, ry, rx = head
    empty = origins[:0].contiguous()
    n0_ms = _time_ms(torch, lambda: extract_regions(stack, empty, ry, rx))
    _log(f"time {HEADLINE} at N = 0: call {n0_ms * 1e3:.1f} us (host side alone)")
    return max_err, timings


def _lk_pass_args(torch, gen, prev, nxt, corners, lvl, top, n, fc):
    """Forward-role arguments of one level pass on real frames: the detected
    corners (tiled to ``n``) at pyramid level ``lvl``, guesses within
    +-slack of them, ~5% of slots inactive as in a live tracker."""
    from stereo_vo_tpu_torch.ops.lk import LK_SLACK, LK_SLACK_TOP, _origins, level_geometry

    dev = prev.device
    half = fc.lk_window // 2
    slack = LK_SLACK_TOP if top else LK_SLACK
    region, m = level_geometry(half, slack)
    h, w = prev.shape
    pts = corners[torch.arange(n, device=dev) % corners.shape[0]] / float(2 ** lvl)
    guess = pts + ((torch.rand((n, 2), generator=gen) * 2 - 1) * slack).to(dev)
    active = (torch.rand(n, generator=gen) > 0.05).to(dev)
    prev_org = _origins(pts, half, slack, m, h + 2 * m, w + 2 * m, region, region)
    next_org = _origins(guess, half, slack, m, h + 2 * m, w + 2 * m, region, region)
    tpl_pos = pts - half + m - prev_org.to(torch.float32)
    return [prev, nxt, prev_org, next_org, tpl_pos, guess, active, None, half, m, region,
            fc.lk_iters, fc.lk_eps, fc.lk_min_eig], pts


def _compare_pass(torch, label, got, want, args) -> dict:
    """Phase 3b's tolerances on one call; returns its errors."""
    from stereo_vo_tpu_torch.ops.lk import _image_inside

    h, w = args[0].shape
    active = args[6]

    def ok(res):
        return res[1] & res[2] & _image_inside(res[0], h, w)

    flips = int((got[1] != want[1]).sum())
    g_ok, w_ok = ok(got), ok(want)
    n_act = max(int(active.sum()), 1)
    ok_share = int(((g_ok == w_ok) & active).sum()) / n_act
    both = g_ok & w_ok
    d = (got[0] - want[0]).abs().amax(dim=1)[both]
    c_err = float(((got[3] - want[3]).abs() / want[3].abs().clamp(min=1.0)).max())
    err = {"solvable_flips": flips, "ok_share": ok_share, "ok_both": int(both.sum()),
           "max_px": float(d.max()) if d.numel() else 0.0,
           "median_px": float(d.median()) if d.numel() else 0.0, "center_rel": c_err,
           "iters_equal": float((got[4] == want[4]).float().mean()),
           "mean_iters": float(got[4][want[1]].float().mean()) if bool(want[1].any()) else 0.0}
    _check(flips <= LK_SOLVABLE_FLIPS, f"{label}: {flips} solvable flips")
    _check(ok_share >= LK_OK_SHARE, f"{label}: ok equal on {ok_share:.4f} of active features")
    _check(err["max_px"] <= LK_POS_TOL and err["median_px"] <= LK_POS_MEDIAN_TOL,
           f"{label}: positions {err}")
    _check(c_err <= LK_CENTER_RTOL, f"{label}: center {c_err}")
    _check(err["ok_both"] > 0, f"{label}: no feature ok in both")
    return err


def _lk_level_check(torch, cfg, world, dev) -> dict:
    """Phase 3b: ``lk_level_pass`` against ``lk_level_pass_ref`` on the card,
    forward and backward role, at ``LK_SHAPES``; returns the headline
    shape's record and the largest position error."""
    from stereo_vo_tpu_torch.frontend.detect import detect_features
    from stereo_vo_tpu_torch.ops.lk import lk_level_pass, lk_level_pass_ref
    from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

    fc = cfg.frontend
    pyrs = [build_pyramid(torch.from_numpy(world.render(i)[0]).to(dev), fc.lk_max_level)
            for i in (0, 1)]
    xy, valid = detect_features(pyrs[0][0], fc)
    corners = xy[valid]
    _log(f"lk level pass inputs: frames 0-1 of the 20-frame world, {len(corners)} corners")
    gen = torch.Generator(device="cpu").manual_seed(1)
    max_px, head = 0.0, None
    for label, lvl, top, n in LK_SHAPES:
        fwd, pts = _lk_pass_args(torch, gen, pyrs[0][lvl], pyrs[1][lvl], corners, lvl, top,
                                 n, fc)
        want = lk_level_pass_ref(*fwd)
        # backward role: the images and origins swap, the template sits at the
        # forward endpoint, the forward constant centers both regions
        half, m = fwd[8], fwd[9]
        slack = m - half - 2
        bwd = list(fwd)
        bwd[0:4] = [fwd[1], fwd[0], fwd[3], fwd[2]]
        bwd[4] = want[0] - half + m - fwd[3].to(torch.float32)
        bwd[5] = pts + ((torch.rand((n, 2), generator=gen) * 2 - 1) * slack).to(dev)
        bwd[6] = want[1] & want[2]
        bwd[7] = want[3]
        for role, args in (("forward", fwd), ("backward", bwd)):
            tag = f"{label} {role}"
            ref = lk_level_pass_ref(*args)
            got = lk_level_pass(*args)
            torch.cuda.synchronize()
            err = _compare_pass(torch, tag, got, ref, args)
            max_px = max(max_px, err["max_px"])
            k_ms = _time_ms(torch, lambda: lk_level_pass(*args))
            p_ms = _time_ms(torch, lambda: lk_level_pass_ref(*args), samples=3, inner=1)
            # bytes: both regions' distinct source pixels, the per-feature
            # inputs (2 origins, tpl_pos, guess, active, center) and outputs
            # (guess, solvable, in_region, iterations); operations: staging
            # (mean and centering), 9 per bilinear sample of the template
            # patch, 27 per window pixel for Scharr and Gram, and 14 per
            # window pixel and iteration (sample, di, two products, two sums)
            h, w = args[0].shape
            region, nwin, wt = args[10], (2 * half + 1) ** 2, (2 * half + 3) ** 2
            nbytes = (4 * (_distinct_pixels(torch, args[2], m, h, w, region, region)
                           + _distinct_pixels(torch, args[3], m, h, w, region, region))
                      + n * (8 + 8 + 8 + 8 + 1 + 4) + n * (8 + 1 + 1 + 4))
            staging = (3 if role == "forward" else 2) * region * region
            flops = n * (staging + 9 * wt + 27 * nwin) + int(got[4].sum()) * 14 * nwin
            bound, bound_by = _bound_ms(nbytes, flops)
            _log(f"check lk {tag}: [{n}] from {h}x{w}, region {region}: {json.dumps(err)}; "
                 f"call {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us, bound "
                 f"{bound * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f} MB, "
                 f"{flops / 1e6:.2f} MFLOP)")
            if tag == LK_HEADLINE:
                dev_us = _device_us(torch, lambda: lk_level_pass(*args), "lk_level_kernel",
                                    lk_level_pass)
                _log(f"check lk {tag}: {dev_us:.2f} us of the call on the device")
                head = {"ms": k_ms, "device_ms": dev_us / 1e3, "plain_ms": p_ms,
                        "bound_ms": bound, "bound_by": bound_by}
    return {**head, "max_abs_err": max_px}


def _lk_inactive_check(torch, cfg, world, dev) -> dict:
    """Phase 3b, inactive slots: at ``LK_INACTIVE_SHAPES`` (forward role),
    the kernel with every other slot inactive against ``lk_level_pass_ref``
    on the same arguments: the inactive slots' guess, solvable, in_region
    and iteration count bitwise, their centre bitwise the all-active
    kernel's (one summation) and within ``LK_CENTER_RTOL`` of the plain
    version's; the active slots bitwise the all-active kernel's and within
    the ``LK_*`` tolerances of the plain version's; the device time per
    launch beside the all-active one's."""
    from stereo_vo_tpu_torch.frontend.detect import detect_features
    from stereo_vo_tpu_torch.ops.lk import lk_level_pass, lk_level_pass_ref
    from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

    fc = cfg.frontend
    pyrs = [build_pyramid(torch.from_numpy(world.render(i)[0]).to(dev), fc.lk_max_level)
            for i in (0, 1)]
    xy, valid = detect_features(pyrs[0][0], fc)
    corners = xy[valid]
    gen = torch.Generator(device="cpu").manual_seed(2)
    out = {}
    for label, lvl, top, n in LK_SHAPES:
        if label not in LK_INACTIVE_SHAPES:
            continue
        full, _ = _lk_pass_args(torch, gen, pyrs[0][lvl], pyrs[1][lvl], corners, lvl, top, n, fc)
        full[6] = torch.ones(n, dtype=torch.bool, device=dev)
        half = list(full)
        half[6] = torch.arange(n, device=dev) % 2 == 0
        got = lk_level_pass(*half)
        all_active = lk_level_pass(*full)
        want = lk_level_pass_ref(*half)
        torch.cuda.synchronize()
        off, on = ~half[6], half[6]
        same_off = {name: bool(torch.equal(got[k][off], want[k][off]))
                    for k, name in ((0, "guess"), (1, "solvable"), (2, "inside"),
                                    (4, "iterations"))}
        center_rel = float(((got[3][off] - want[3][off]).abs()
                            / want[3][off].abs().clamp(min=1.0)).max())
        same_center = bool(torch.equal(got[3][off], all_active[3][off]))
        same_on = all(bool(torch.equal(g[on], a[on])) for g, a in zip(got, all_active))
        err = _compare_pass(torch, f"{label} half inactive", got, want, half)
        half_us = _device_us(torch, lambda: lk_level_pass(*half), "lk_level_kernel",
                             lk_level_pass)
        full_us = _device_us(torch, lambda: lk_level_pass(*full), "lk_level_kernel",
                             lk_level_pass)
        out[label] = {"inactive_bitwise": same_off, "inactive_center_rel": center_rel,
                      "inactive_center_equals_all_active": same_center,
                      "active_equal_all_active": same_on, "active": err,
                      "device_us_half_inactive": half_us, "device_us_all_active": full_us}
        _log(f"check lk {label} forward, every other slot inactive: " + json.dumps(out[label]))
        _check(all(same_off.values()), f"{label}: inactive slots differ from the plain version "
                                       f"{same_off}")
        _check(same_center and center_rel <= LK_CENTER_RTOL,
               f"{label}: inactive centres {center_rel}, equal to all-active {same_center}")
        _check(same_on, f"{label}: active slots differ from the all-active call")
    return out


def _fast_motion_check(torch, dev) -> float:
    """Phase 3b, fast motion: ``lk_track_fwdbwd`` through the kernel against
    the same call through ``lk_level_pass_ref`` on tests/test_lk_fast_motion.py's
    scene shifted by each of ``FAST_SHIFTS``; returns the largest position
    difference."""
    import numpy as np

    import stereo_vo_tpu_torch.ops.lk as lk
    from stereo_vo_tpu_torch.data.synthetic import _smooth_noise
    from stereo_vo_tpu_torch.ops.pyramid import build_pyramid
    from stereo_vo_tpu_torch.ops.shi_tomasi import detect_corners

    rng = np.random.default_rng(3)
    scene = np.clip(128.0 + _smooth_noise(rng, 376, 1241, octaves=5, amp=55.0), 0, 255)
    img = torch.from_numpy(scene.astype(np.uint8).astype(np.float32)).to(dev)
    w = img.shape[1]
    corners, _, found = detect_corners(img, max_corners=128, min_distance=30.0)
    max_px = 0.0
    for shift in FAST_SHIFTS:
        cur = torch.zeros_like(img)
        cur[:, shift:] = img[:, : w - shift]
        valid = found & (corners[:, 0] + shift < w - 30)
        xy = torch.where(valid[:, None], corners, torch.tensor([5.0, 7.0], device=dev))
        args = (build_pyramid(img, 3), build_pyramid(cur, 3), xy, valid)
        before = lk.lk_level_pass.launches
        got = lk.lk_track_fwdbwd(*args, window=21, max_iters=30)
        torch.cuda.synchronize()
        launched = lk.lk_level_pass.launches - before
        kernel, lk.lk_level_pass = lk.lk_level_pass, lk.lk_level_pass_ref
        try:
            want = lk.lk_track_fwdbwd(*args, window=21, max_iters=30)
        finally:
            lk.lk_level_pass = kernel
        flips = int((got[1] != want[1]).sum()) + int((got[3] != want[3]).sum())
        ok = want[1] & got[1]
        d = float((got[0] - want[0]).abs().amax(dim=1)[ok].max())
        err = float((got[0][ok, 0] - (xy[ok, 0] + shift)).abs().median())
        max_px = max(max_px, d)
        _log(f"check lk fast motion {shift} px: {launched} level passes on the card, "
             f"{int(valid.sum())} corners, {int(got[1].sum())} forward ok, "
             f"{int((got[1] & got[3]).sum())} both ok, flag flips against the plain path "
             f"{flips}, max |kernel - plain| {d:.3g} px, median |tracked - truth| {err:.3g} px")
        _check(launched == 8, f"fast motion {shift} px: {launched} launches for 8 level passes")
        _check(flips == 0, f"fast motion {shift} px: {flips} fwd/bwd flags flipped")
        _check(d <= LK_POS_TOL and err < 1.0, f"fast motion {shift} px: {d} px, error {err} px")
    return max_px


def _response_check(torch, photo_left, dev) -> None:
    """Phase 4, the Shi-Tomasi response on a photo-world frame: the card's
    against the CPU's, bitwise, for one image and a stack of three; and the
    device time per frame against the former formula (rounded products, a
    library square root)."""
    from stereo_vo_tpu_torch.core.f32 import sqrt_f32
    from stereo_vo_tpu_torch.ops.filters import box_filter, sobel_x, sobel_y
    from stereo_vo_tpu_torch.ops.shi_tomasi import count_quality_peaks, min_eig_response
    from stereo_vo_tpu_torch.utils.profiling import device_ms

    cpu = torch.from_numpy(photo_left).to(torch.float32)
    card = cpu.to(dev)
    want = min_eig_response(cpu)
    got = min_eig_response(card).cpu()
    stack = torch.stack([cpu, cpu.flip(1), cpu.flip(0)])
    stack_diff = int((min_eig_response(stack.to(dev)).cpu() != min_eig_response(stack)).sum())
    diff = int((got != want).sum())
    peaks = (int(count_quality_peaks(card, resp=min_eig_response(card))),
             int(count_quality_peaks(cpu, resp=want)))

    def former(img):
        ix, iy = sobel_x(img), sobel_y(img)
        a, b, c = box_filter(ix * ix, 1), box_filter(ix * iy, 1), box_filter(iy * iy, 1)
        return ((a + c) - torch.sqrt((a - c) ** 2 + 4.0 * b * b)) * 0.5

    # the root the response takes on the card (torch.sqrt) against the CPU's
    # correctly rounded one, on float32 inputs across the exponent range
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.rand(1 << 22, generator=gen) * torch.exp2(
        torch.randint(-120, 120, (1 << 22,), generator=gen).to(torch.float32))
    x = torch.cat([x, torch.rand(1 << 22, generator=gen) * 1e7])
    root_diff = int((sqrt_f32(x.to(dev)).cpu() != sqrt_f32(x)).sum())
    _log(f"torch.sqrt on the card against the correctly rounded float32 root: {root_diff} of "
         f"{x.numel()} inputs differ")
    _check(root_diff == 0, f"the card's square root differs at {root_diff} inputs")
    new_ms = device_ms(lambda: min_eig_response(card), calls=10)
    old_ms = device_ms(lambda: former(card), calls=10)
    _log(f"response on photo frame 0 ({tuple(cpu.shape)}): {diff} pixels differ between the "
         f"card and the CPU ({stack_diff} on a stack of 3), quality peaks {peaks[0]} on the "
         f"card, {peaks[1]} on the CPU; device time per frame {new_ms:.4f} ms, the former "
         f"formula's {old_ms:.4f} ms (+{new_ms - old_ms:.4f} ms)")
    _check(diff == 0 and stack_diff == 0, f"response differs at {diff} + {stack_diff} pixels")
    _check(peaks[0] == peaks[1], f"quality peaks {peaks}")


def _bm_slot_sets(torch, cfg, frame0, frame1, dev):
    """Phase 3c's inputs on one stereo pair: the images and ``{set: (xy,
    valid, compact_slots)}`` for each of ``BM_SETS``."""
    from stereo_vo_tpu_torch.frontend.detect import detect_features
    from stereo_vo_tpu_torch.utils.profiling import keyframe_bm_input

    compact = cfg.frontend.bm_compact_slots
    left, right, xy, valid = keyframe_bm_input(cfg, frame0, frame1, dev)
    _, _, xy_all, valid_all = keyframe_bm_input(cfg, frame0, frame1, dev, live=False)
    det_xy, det_valid = detect_features(left, cfg.frontend)
    none = torch.zeros_like(valid)
    return left, right, {
        "bootstrap_n300": (det_xy, det_valid, 0),
        "keyframe_n748_le320": (xy, valid, compact),
        "keyframe_n748_all_valid": (xy_all, valid_all, compact),
        "all_invalid_n748": (xy, none, compact),
        "empty_n0": (xy[:0].contiguous(), none[:0].contiguous(), compact),
    }


def _bm_bound(torch, fc, h, w, xy, valid):
    """Phase 3c's bound: the distinct raw pixels the valid slots read from
    each image (window and band with the 1-pixel Sobel halo) read once, 9 B
    in and 4 B out per slot; operations per valid slot: 3 per SAD term, 13
    per prefiltered pixel, 3 per texture term and the D x block row sums."""
    d, blk = fc.bm_num_disparities, fc.bm_block_size
    r = blk // 2
    xi = xy[valid, 0].to(torch.int64).clamp(0, w - 1)
    yi = xy[valid, 1].to(torch.int64).clamp(0, h - 1)
    org_l = torch.stack([xi - r - 1, yi - r - 1], dim=1)
    org_r = torch.stack([xi - (d - 1) - r - 1, yi - r - 1], dim=1)
    nbytes = (4 * (_distinct_pixels(torch, org_l, 0, h, w, blk + 2, blk + 2)
                   + _distinct_pixels(torch, org_r, 0, h, w, blk + 2, d + blk + 1))
              + 13 * xy.shape[0])
    per_slot = 3 * d * blk * blk + 13 * blk * (d + 2 * blk - 1) + 3 * blk * blk + d * blk
    flops = int(valid.sum()) * per_slot
    return _bound_ms(nbytes, flops) + (nbytes, flops)


def _bm_kernel_check(torch, cfg, pairs, dev) -> dict:
    """Phase 3c: ``stereo_bm_at`` against ``stereo_bm_at_ref`` on the card
    at ``BM_SETS`` on each ``(label, frame0, frame1)`` of ``pairs``; returns
    the headline's record and the largest difference."""
    from stereo_vo_tpu_torch.ops.stereo_bm import stereo_bm_at, stereo_bm_at_ref

    fc = cfg.frontend
    kw = dict(num_disparities=fc.bm_num_disparities, block_size=fc.bm_block_size,
              prefilter_cap=fc.bm_prefilter_cap, texture_threshold=fc.bm_texture_threshold,
              uniqueness_ratio=fc.bm_uniqueness_ratio)
    max_err, head = 0.0, None
    for pair, frame0, frame1 in pairs:
        left, right, sets = _bm_slot_sets(torch, cfg, frame0, frame1, dev)
        h, w = left.shape
        for name in BM_SETS:
            xy, valid, compact = sets[name]
            tag = f"{pair} {name}"
            got = stereo_bm_at(left, right, xy, valid, compact_slots=compact, **kw)
            torch.cuda.synchronize()
            want = stereo_bm_at_ref(left, right, xy, valid, compact_slots=compact, **kw)
            _check(got.shape == want.shape and torch.equal(got, want),
                   f"sparse BM kernel equals the plain version at {tag}")
            if got.numel():
                max_err = max(max_err, float((got - want).abs().max()))
            call = lambda: stereo_bm_at(left, right, xy, valid, compact_slots=compact, **kw)
            k_ms = _time_ms(torch, call)
            dev_us = _device_us(torch, call, "stereo_bm_at_kernel", stereo_bm_at)
            p_ms = _time_ms(torch, lambda: stereo_bm_at_ref(left, right, xy, valid,
                                                            compact_slots=compact, **kw))
            bound, bound_by, nbytes, flops = _bm_bound(torch, fc, h, w, xy, valid)
            _log(f"check bm {tag}: [{xy.shape[0]}] slots, {int(valid.sum())} valid, "
                 f"{int((want > 0).sum())} with a disparity, bitwise equal; call "
                 f"{k_ms * 1e3:.1f} us ({dev_us:.2f} us of it on the device), plain "
                 f"{p_ms * 1e3:.1f} us, bound {bound * 1e3:.3f} us ({bound_by}: "
                 f"{nbytes / 1e6:.3f} MB, {flops / 1e6:.2f} MFLOP)")
            if tag == BM_HEADLINE:
                head = {"ms": k_ms, "device_ms": dev_us / 1e3, "plain_ms": p_ms,
                        "bound_ms": bound, "bound_by": bound_by}
    return {**head, "max_abs_err": max_err}


def _bits_equal(torch, a, b) -> bool:
    """``a`` and ``b`` bitwise equal (NaN payloads and signed zeros too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _abs_err(torch, a, b) -> float:
    """The largest |a - b|, 0 where both are NaN or equal infinities, and 0
    for empty tensors."""
    if a.numel() == 0:
        return 0.0
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return float(torch.where(same, 0.0, (a - b).abs().nan_to_num(float("inf"))).max())


def _nms_pool(name: str):
    """A seeded candidate pool for the edges of ``csrc/greedy_nms.cu``, as
    ``tests/torch_port_helpers.py::nms_pool`` makes it: ``(cxy [C, 2] f32,
    cvalid [C] bool, r2)`` in numpy. ``random<C>_sparse`` / ``_dense``:
    integer pixels over a 1241x376 frame / a 160x160 patch, 90% valid;
    ``cell_borders``: r2 1024 (cell side 32) and coordinates on, and one ulp
    either side of, multiples of 32; ``wide``: spread over a million pixels,
    where the grid's cells grow; ``nonfinite``: NaN, infinite and
    near-overflow coordinates in a cluster."""
    import numpy as np

    f32 = np.float32
    up = lambda v: np.nextafter(f32(v), f32(np.inf))        # noqa: E731
    down = lambda v: np.nextafter(f32(v), f32(-np.inf))     # noqa: E731
    if name.startswith("random"):
        c, density = name[6:].split("_")
        c = int(c)
        rng = np.random.default_rng(c * 2 + (density == "dense"))
        span = (1241, 376) if density == "sparse" else (160, 160)
        cxy = np.stack([rng.integers(0, span[0], c), rng.integers(0, span[1], c)], 1)
        return cxy.astype(f32), rng.random(c) < 0.9, 900.0
    if name == "cell_borders":
        tiny = np.nextafter(f32(0), f32(1))
        xs = [-64.0, down(-32), -32.0, up(-32), -tiny, -0.0, 0.0, tiny, down(32), 32.0, up(32),
              down(64), 64.0, up(64), down(96), 96.0, down(128)]
        ys = [0.0, down(32), 32.0, up(32), 64.0, down(-32)]
        cxy = np.array([[x, y] for y in ys for x in xs], f32)
        order = np.random.default_rng(5).permutation(len(cxy))
        return cxy[order], np.ones(len(cxy), bool), 1024.0
    if name == "wide":
        rng = np.random.default_rng(7)
        spread = rng.integers(0, 1_000_000, (512, 2))
        near = rng.integers(0, 80, (512, 2)) + rng.integers(0, 4, (512, 1)) * 250_000
        cxy = np.concatenate([spread, near])[rng.permutation(1024)]
        return cxy.astype(f32), rng.random(1024) < 0.9, 900.0
    rng = np.random.default_rng(9)          # nonfinite
    cxy = rng.integers(0, 100, (256, 2)).astype(f32)
    odd = [np.nan, np.inf, -np.inf, f32(3e38), f32(-3e38)]
    for k in range(40):
        cxy[rng.integers(0, 256), rng.integers(0, 2)] = odd[k % len(odd)]
    return cxy, rng.random(256) < 0.95, 900.0


def _nms_sets(torch, cfg, world, photo, dev) -> dict:
    """Phase 3d's inputs: ``{set: (cxy, cvalid, cvals, r2)}`` on the card,
    the candidate pools of frames 0-4 of the 20-frame world and of a photo
    frame (their own responses), 1024 valid candidates in one conflict
    chain (each conflicts with its neighbours only), 1024 with none valid,
    clusters at the corners of a 376x1241 frame, and ``NMS_POOLS``
    (``_nms_pool``); where a set has no responses, descending ones stand in."""
    from stereo_vo_tpu_torch.ops.shi_tomasi import corner_candidates

    fc = cfg.frontend
    r2 = fc.min_distance * fc.min_distance
    sets = {}
    for i in range(5):
        img = torch.from_numpy(world.render(i)[0]).to(dev).to(torch.float32)
        cxy, cvals = corner_candidates(img, fc.quality_level, fc.min_distance,
                                       fc.detect_block_size)
        sets[f"billboard{i}"] = (cxy, cvals > 0, cvals, r2)
    cxy, cvals = corner_candidates(torch.from_numpy(photo).to(dev).to(torch.float32),
                                   fc.quality_level, fc.min_distance, fc.detect_block_size)
    sets["photo0"] = (cxy, cvals > 0, cvals, r2)

    def stand_in(cxy, cvalid, r2):
        cvals = torch.where(cvalid, torch.linspace(2.0, 1.0, cxy.shape[0], device=dev), -1.0)
        return cxy, cvalid, cvals, r2

    x = torch.arange(1024, dtype=torch.float32, device=dev)
    ones = torch.ones(1024, dtype=torch.bool, device=dev)
    sets["chain1024"] = stand_in(torch.stack([x, torch.full_like(x, 7.0)], 1), ones, 4.0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    pts = (torch.rand((1024, 2), generator=gen) * 1000).floor().to(dev)
    sets["none_valid"] = stand_in(pts, torch.zeros_like(ones), r2)
    corners = torch.tensor([[0.0, 0.0], [1240.0, 0.0], [0.0, 375.0], [1240.0, 375.0]])
    off = torch.randint(0, 40, (1024, 2), generator=gen).to(torch.float32)
    k = torch.arange(1024) % 4
    cxy = corners[k] + off * torch.where(corners > 0, -1.0, 1.0)[k]
    sets["corners"] = stand_in(cxy.to(dev), (torch.rand(1024, generator=gen) < 0.9).to(dev), r2)
    for name in NMS_POOLS:
        cxy, cvalid, pool_r2 = _nms_pool(name)
        sets[name] = stand_in(torch.from_numpy(cxy).to(dev), torch.from_numpy(cvalid).to(dev),
                              pool_r2)
    return sets


def _nms_check(torch, cfg, world, photo, dev) -> dict:
    """Phase 3d: ``greedy_nms`` against its plain versions on the card at
    the sets of ``_nms_sets``, bitwise, one launch per call: the accepted
    set (``greedy_nms_rounds``, with its rounds) with the kernel's counts
    (conflict pairs, bit-row candidates, grid, SM cycles by phase), and
    detection's capped pack at
    ``max_detect`` (``greedy_nms_pack_ref``); the pack's call timed (CUDA
    events) beside the plain version, its device time per launch from
    ``torch.profiler`` and the bound. Returns the headline's record and the
    largest difference (in accepted flags and packed values)."""
    import numpy as np

    from stereo_vo_tpu_torch.ops.shi_tomasi import (
        NMS_STATS,
        greedy_nms,
        greedy_nms_pack_ref,
        greedy_nms_rounds,
    )

    k = cfg.frontend.max_detect
    head, max_err = None, 0.0
    for name, (cxy, cvalid, cvals, r2) in _nms_sets(torch, cfg, world, photo, dev).items():
        stats = torch.zeros(len(NMS_STATS), dtype=torch.int64, device=dev)
        before = greedy_nms.launches
        got = greedy_nms(cxy, cvalid, r2, stats=stats)
        torch.cuda.synchronize()
        _check(greedy_nms.launches == before + 1, f"greedy_nms: one launch at {name}")
        want, rounds = greedy_nms_rounds(cxy, cvalid, r2)
        max_err = max(max_err, float((got.float() - want.float()).abs().max()))
        _check(torch.equal(got, want), f"greedy_nms equals its plain version at {name}")
        if name == "chain1024":
            _check(torch.equal(got.cpu(), torch.arange(1024) % 2 == 0), "chain: every other one")
        counts = dict(zip(NMS_STATS, stats.tolist()))
        side = float(np.int32(counts.pop("cell_side_bits")).view(np.float32))
        packed = greedy_nms(cxy, cvalid, r2, cvals, k)
        torch.cuda.synchronize()
        _check(greedy_nms.launches == before + 2, f"greedy_nms: one launch for the pack at {name}")
        plain = greedy_nms_pack_ref(cxy, cvalid, cvals, r2, k)
        for g, w in zip(packed, plain):
            max_err = max(max_err, _abs_err(torch, g, w))
            _check(_bits_equal(torch, g, w),
                   f"greedy_nms's pack equals its plain version at {name}")
        call = lambda: greedy_nms(cxy, cvalid, r2, cvals, k)
        k_ms = _time_ms(torch, call)
        dev_us = _device_us(torch, call, "greedy_nms_kernel", greedy_nms)
        p_ms = _time_ms(torch, lambda: greedy_nms_pack_ref(cxy, cvalid, cvals, r2, k),
                        samples=5, inner=2)
        c, n_valid = cxy.shape[0], int(cvalid.sum())
        # bytes: 13 in per candidate (xy, valid, response) and 13 out per
        # packed row; operations: one pair test (two differences, two
        # products, a sum) per conflicting pair, the least any build tests
        bound, bound_by = _bound_ms(13 * (c + min(c, k)), 5.0 * counts["pairs"])
        _log(f"check greedy_nms {name}: {c} candidates, {n_valid} valid, {int(got.sum())} "
             f"accepted, {rounds} rounds of the plain fixpoint, {counts['pairs']} conflict "
             f"pairs ({counts['bit_rows']} candidates in bit rows), grid {counts['grid_w']}x"
             f"{counts['grid_h']} cells of {side:g} px, bitwise equal (fixpoint and pack); "
             f"pack call {k_ms * 1e3:.2f} us ({dev_us:.2f} us of it on the device), plain "
             f"{p_ms * 1e3:.1f} us, bound {bound * 1e3:.4f} us ({bound_by}); SM cycles by "
             f"phase " + json.dumps({key[7:]: v for key, v in counts.items()
                                     if key.startswith("cycles_")}))
        if name == NMS_HEADLINE:
            head = {"ms": k_ms, "device_ms": dev_us / 1e3, "plain_ms": p_ms,
                    "bound_ms": bound, "bound_by": bound_by}
    return {**head, "max_abs_err": max_err}


def _block_err(torch, *pairs, scale=None, allow=None) -> float:
    """The largest error of kernel outputs against their plain versions
    ``(got, want)``, each output's first dimension a landmark (or a pose),
    in units of the largest magnitude of that landmark's plain outputs
    together (or of ``scale``, one per landmark), and less ``allow`` (one
    per landmark, what its own arithmetic amplifies) where given; a
    landmark whose scale is zero must match exactly."""
    def rows(t):
        return t.double().flatten(1) if t.dim() > 1 else t.double()[:, None]

    err = torch.stack([(rows(g) - rows(w)).abs().amax(1) for g, w in pairs]).amax(0)
    if scale is None:
        scale = torch.stack([rows(w).abs().amax(1) for _, w in pairs]).amax(0)
    _check(bool(torch.all(torch.isfinite(err))), "finite kernel outputs")
    exact = scale == 0
    _check(bool(torch.all(err[exact] == 0)), "zero blocks exactly zero")
    rel = err[~exact] / scale[~exact]
    if allow is not None:
        rel = rel - allow.double()[~exact]
    return float(rel.max()) if bool((~exact).any()) else 0.0


def _huber_amp(torch, prob, cam, bcfg):
    """Per landmark, the largest ``|uv| / |r|`` over its masked-in
    observations whose residual lies in the Huber tail (``|r| > delta``),
    and 0 without one: how much a rounding of the projection moves the
    landmark's Huber weights, relatively (``BA_HUBER_ULPS``)."""
    from stereo_vo_tpu_torch.backend import schur
    from stereo_vo_tpu_torch.backend.residuals import reprojection_residual

    pose_b, pts, mask = schur._obs_mask(prob.poses, prob.lm_pos, prob, bcfg.min_depth)
    r = reprojection_residual(pose_b, pts, prob.obs_uv, cam).double()
    norm = r.norm(dim=-1)
    uv = (r + prob.obs_uv.double()).abs().amax(-1)
    tail = mask & (norm > bcfg.huber_delta_px) if bcfg.huber_delta_px > 0 else mask & False
    return torch.where(tail, uv / norm.clamp(min=1e-30), 0.0).amax(-1)


def _step_scale(torch, sys, v_inv, delta, corr, lm_pos):
    """Per landmark, the largest magnitude of a step's landmark block: its
    position, and the products ``v_inv[i, j] * (g_l - wl^T delta_p)[j]``
    its back-substitution sums (a far landmark's ``v_inv`` is large, and
    multiplies the rounding of the difference that it sums)."""
    w = sys.wl.shape[1]
    d = (delta if corr is None else delta + corr).double().reshape(w, 6)
    d = d * sys.free.double()[:, None]
    gw = sys.g_l.double() - torch.sum(sys.wl.double() * d[None, :, :, None], dim=(1, 2))
    terms = (v_inv.double().abs() * gw.abs()[:, None, :]).flatten(1).amax(1)
    return torch.maximum(lm_pos.double().abs().amax(1), terms)


def _grad_err(got, want, u_blocks, cost) -> float:
    """The largest error of a summed pose gradient ``g_p = -sum J^T r``
    against its plain version, each entry in units of the Cauchy-Schwarz
    bound on the sum of its terms' magnitudes, ``sqrt(U_aa * sum w r^2)``
    with ``sum w r^2 <= 2 * cost`` (a gradient near an optimum sums terms
    that cancel)."""
    scale = (u_blocks.double().diagonal(dim1=-2, dim2=-1) * 2.0 * float(cost)).sqrt()
    return float(((got.double() - want.double()).abs() / scale.clamp(min=1e-30)).max())


def _sum_err(got, want, *formed_from) -> float:
    """The largest error of a landmark-summed ``got`` against ``want`` in
    units of the largest magnitude of ``want`` and of what it is formed
    from."""
    scale = max(float(t.double().abs().max()) for t in (want, *formed_from))
    return float((got.double() - want.double()).abs().max()) / max(scale, 1e-30)


def _moved(torch, tree, device):
    """A tree of tensors (``engine/graphs.py``'s trees) on ``device``, each
    contiguous."""
    from stereo_vo_tpu_torch.engine.graphs import flatten, unflatten

    leaves, spec = flatten(tree)
    return unflatten(spec, iter([t.to(device).contiguous() for t in leaves]))


def _ba_problems(cfg, windows):
    """For each recorded ``(window, compact)``, compacted and full, the
    landmark-major problem the LM loop of ``bundle_adjust`` starts from,
    its damping, and that solve's results (through the kernels):
    ``[(label, prob, init_lam, result), ...]``, the first the headline."""
    from stereo_vo_tpu_torch.backend import schur

    out, run = [], schur._lm_run
    for k, (window, compact) in enumerate(windows):
        for c in (compact, not compact):
            seen = []

            def recording(prob, cam, bcfg, init_lam=None, group=None):
                result = run(prob, cam, bcfg, init_lam, group)
                seen.append((prob, init_lam, result))
                return result

            schur._lm_run = recording
            try:
                schur.bundle_adjust(window, cfg.camera, cfg.backend, compact=c)
            finally:
                schur._lm_run = run
            label = f"step {BA_STEPS[k]} {'compacted' if c else 'full'}"
            out.append((label, *seen[0]))
    return out


def _ba_check(torch, cfg, frames, dev) -> dict:
    """Phase 3e: ``_ba_hold`` on the windows the bundle adjustments of steps
    ``BA_STEPS`` of phase 4's world start from, each compacted and full; at
    the headline each kernel's call timed (CUDA events) beside its plain
    version and its device time per launch (``torch.profiler``) and bound,
    ``ba_damp_reduce`` beside the one ``einsum`` of its Gram. Returns each
    kernel's record."""
    from stereo_vo_tpu_torch.backend import schur
    from stereo_vo_tpu_torch.utils.profiling import recorded_solves

    windows = recorded_solves(cfg, frames, dev, BA_STEPS)
    _check(len(windows) == len(BA_STEPS), f"{len(windows)} recorded solves")
    records, errs = {}, {}
    for n, (label, prob, init_lam, got) in enumerate(_ba_problems(cfg, windows)):
        case_errs, timing_in = _ba_hold(torch, cfg, label, prob, init_lam, got, dev)
        for kernel, err in case_errs.items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        if n == 0:
            records = _ba_times(torch, schur, prob, *timing_in, cfg.camera, cfg.backend)
    for kernel, rec in records.items():
        rec["max_abs_err"] = errs[kernel]
    return records


def _ba_hold(torch, cfg, label, prob, init_lam, got, dev):
    """Each BA kernel of ``csrc/ba_lm.cu`` on the card against its plain
    version (``backend/schur.py``) on the CPU, from the same inputs, at one
    landmark-major problem: ``ba_cost`` against ``_lm_major_cost_ref`` and
    ``ba_build`` against ``_build_system`` at its iterate,
    ``ba_damp_reduce`` against ``_reduced_system`` on that system at its
    damping, ``ba_step`` against ``_ba_step_ref`` from the plain reduced
    solve (the ``BA_*`` tolerances); and ``got``, the LM loop's results
    through the kernels, against the same loop through the plain versions:
    ``it`` and ``accepted`` equal, poses within ``BA_POSE_TOL``. Returns the
    largest absolute error of each kernel's outputs and the inputs its times
    are taken on."""
    from stereo_vo_tpu_torch.backend import schur

    bcfg, cam = cfg.backend, cfg.camera
    cpu = torch.device("cpu")
    l, w = prob.obs_valid.shape
    lam = (torch.full((), bcfg.init_damping, device=dev) if init_lam is None else
           torch.clamp(torch.as_tensor(init_lam, dtype=torch.float32, device=dev),
                       bcfg.min_damping, bcfg.max_damping))
    # the plain versions on the CPU, where the port's tests hold them to the
    # JAX package; the kernels on the card from the same inputs
    prob_c, lam_c = _moved(torch, prob, cpu), lam.cpu()
    args_c = (prob_c.poses, prob_c.lm_pos, prob_c, cam, bcfg.min_depth, bcfg.huber_delta_px)
    cost_p = schur._lm_major_cost_ref(*args_c)
    sys_p = _moved(torch, schur._build_system(*args_c[:4], bcfg), cpu)
    damp_p = schur._reduced_system(sys_p, lam_c)
    delta, corr = schur._reduced_solve(damp_p[0], damp_p[1], None, bcfg)
    zero_i = torch.zeros((), dtype=torch.int32)
    carry_p = schur._LMCarry(prob_c.poses, prob_c.lm_pos, sys_p, lam_c, torch.full((), 2.0),
                             cost_p, zero_i, zero_i, torch.zeros(()),
                             torch.zeros((), dtype=torch.bool))
    step_p = schur._ba_step_ref(carry_p, damp_p[2], delta, corr, prob_c, cam, bcfg)
    cost_k = schur.ba_cost(prob.poses, prob.lm_pos, prob, cam, bcfg.min_depth,
                           bcfg.huber_delta_px)
    sys_k = schur.ba_build(prob.poses, prob.lm_pos, prob, cam, bcfg)
    sys_in = _moved(torch, sys_p, dev)
    damp_k = schur.ba_damp_reduce(sys_in, lam, bcfg)
    carry_k = _moved(torch, carry_p, dev)
    step_in = _moved(torch, (damp_p[2], delta, corr), dev)
    step_k = schur.ba_step(carry_k, *step_in, prob, cam, bcfg)
    # the same torch ops on the card, for the record: their projections round
    # otherwise than the CPU's (BA_HUBER_ULPS)
    sys_t = schur._build_system(prob.poses, prob.lm_pos, prob, cam, bcfg)
    sys_k, damp_k, step_k, sys_t, cost_k = _moved(torch, (sys_k, damp_k, step_k, sys_t,
                                                           cost_k), cpu)
    e = {
        "ba_cost": _sum_err(cost_k, cost_p),
        "ba_build": _block_err(torch, (sys_k.v, sys_p.v), (sys_k.g_l, sys_p.g_l),
                               (sys_k.wl, sys_p.wl),
                               allow=BA_HUBER_ULPS * 2.0 ** -24 * _huber_amp(torch, prob_c, cam,
                                                                            bcfg)),
        "ba_build_sums": max(_sum_err(sys_k.u_blocks, sys_p.u_blocks),
                             _grad_err(sys_k.g_p, sys_p.g_p, sys_p.u_blocks, cost_p)),
        "ba_damp_reduce": _block_err(torch, (damp_k[2], damp_p[2])),
        "ba_damp_reduce_sums": max(_sum_err(damp_k[0], damp_p[0], sys_p.u_blocks),
                                   _sum_err(damp_k[1], damp_p[1], sys_p.g_p)),
        "ba_step": max(_block_err(torch, (step_k.lm_pos, step_p.lm_pos),
                                  scale=_step_scale(torch, sys_p, damp_p[2], delta, corr,
                                                    step_p.lm_pos)),
                       _block_err(torch, (step_k.poses, step_p.poses))),
        "ba_step_sums": max(_sum_err(step_k.cost, step_p.cost), _sum_err(step_k.lam, step_p.lam)),
    }
    torch_on_card = {
        "build": _block_err(torch, (sys_t.v, sys_p.v), (sys_t.g_l, sys_p.g_l),
                            (sys_t.wl, sys_p.wl)),
        "build_sums": max(_sum_err(sys_t.u_blocks, sys_p.u_blocks),
                          _grad_err(sys_t.g_p, sys_p.g_p, sys_p.u_blocks, cost_p))}
    same = {"lm_active": torch.equal(sys_k.lm_active, sys_p.lm_active),
            "free": torch.equal(sys_k.free, sys_p.free),
            "rhs_copy": torch.equal(damp_k[3], damp_k[1]),
            **{f: bool(torch.equal(getattr(step_k, f), getattr(step_p, f)))
               for f in ("ok", "done", "accepted", "it")}}
    plain = schur._lm_run(prob_c, cam, bcfg, None if init_lam is None else lam_c)
    stops = {"it": (int(got[7]), int(plain[7])), "accepted": (int(got[4]), int(plain[4]))}
    pose_err = _abs_err(torch, got[0].cpu(), plain[0])
    _log(f"check BA kernels {label}: L {l} W {w}, errors against the plain versions on the "
         f"CPU {json.dumps(e)} (the torch ops of _build_system on the card against them: "
         f"{json.dumps(torch_on_card)}), equal {json.dumps(same)}, the LM loop's (it, "
         f"accepted) kernels vs plain {json.dumps(stops)}, poses {pose_err:.3g}")
    for kernel in ("ba_build", "ba_damp_reduce", "ba_step"):
        _check(e[kernel] <= BA_LM_TOL, f"{label}: {kernel} per landmark {e[kernel]:.3g}")
    for kernel in ("ba_build", "ba_damp_reduce", "ba_step"):
        _check(e[kernel + "_sums"] <= BA_SUM_RTOL,
               f"{label}: {kernel} summed {e[kernel + '_sums']:.3g}")
    _check(e["ba_cost"] <= BA_SUM_RTOL, f"{label}: ba_cost {e['ba_cost']:.3g}")
    _check(all(same.values()), f"{label}: equal flags and counts {same}")
    _check(stops["it"][0] == stops["it"][1] and stops["accepted"][0] == stops["accepted"][1],
           f"{label}: the LM loop stops as the plain one: {stops}")
    _check(pose_err <= BA_POSE_TOL, f"{label}: poses within {BA_POSE_TOL}: {pose_err}")
    pairs = {"ba_cost": [(cost_k, cost_p)], "ba_build": list(zip(sys_k, sys_p)),
             "ba_damp_reduce": list(zip(damp_k[:3], damp_p)), "ba_step": list(zip(step_k, step_p))}
    abs_errs = {k: max(_abs_err(torch, g, w) for g, w in outs) for k, outs in pairs.items()}
    return abs_errs, (lam, sys_in, carry_k, step_in)


def _ba_times(torch, schur, prob, lam, sys, carry, step_in, cam, bcfg) -> dict:
    """Phase 3e's times at the headline: each BA kernel's call and its
    plain version's (CUDA events), its device time per launch
    (``torch.profiler``) and its bound from this problem's bytes and
    operations; ``ba_damp_reduce`` also beside its Gram as one ``einsum``
    (cuBLAS)."""
    l, w = prob.obs_valid.shape
    n1 = 6 * w + 1
    v_inv, delta, corr = step_in
    mask = schur._obs_mask(prob.poses, prob.lm_pos, prob, bcfg.min_depth)[2]
    n_obs, n_active = int(mask.sum()), int(sys.lm_active.sum())

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    problem_bytes = nbytes(prob.obs_uv, prob.obs_valid, prob.pose_valid, prob.lm_valid,
                           prob.lm_prior, prob.lm_prior_w)
    args = (prob.poses, prob.lm_pos, prob, cam, bcfg.min_depth, bcfg.huber_delta_px)
    wlg = torch.cat([sys.wl.reshape(l, 6 * w, 3), sys.g_l[:, None, :]], dim=1)
    a = torch.sum(wlg[:, :, :, None] * v_inv[:, None, :, :], dim=2)
    cases = {
        "ba_build": (lambda: schur.ba_build(prob.poses, prob.lm_pos, prob, cam, bcfg),
                     lambda: schur._build_system(prob.poses, prob.lm_pos, prob, cam, bcfg),
                     None,
                     problem_bytes + nbytes(prob.poses, prob.lm_pos, *sys),
                     BA_BUILD_OPS_PER_OBS * n_obs),
        "ba_damp_reduce": (lambda: schur.ba_damp_reduce(sys, lam, bcfg),
                           lambda: schur._reduced_system(sys, lam),
                           lambda: torch.einsum("lic,ljc->ij", a, wlg),
                           nbytes(*sys, lam, v_inv) + 4 * (36 * w * w + 12 * w),
                           n_active * (BA_DAMP_OPS_PER_LM + BA_GRAM_OPS * n1 * n1)),
        "ba_step": (lambda: schur.ba_step(carry, v_inv, delta, corr, prob, cam, bcfg),
                    lambda: schur._ba_step_ref(carry, v_inv, delta, corr, prob, cam, bcfg),
                    None,
                    problem_bytes + nbytes(prob.poses, prob.lm_pos, *sys, v_inv, delta, corr)
                    + nbytes(prob.poses, prob.lm_pos) + 4 * 10,
                    l * BA_STEP_OPS_PER_LM + BA_COST_OPS_PER_OBS * n_obs),
        "ba_cost": (lambda: schur.ba_cost(*args), lambda: schur._lm_major_cost_ref(*args), None,
                    problem_bytes + nbytes(prob.poses, prob.lm_pos) + 4,
                    BA_COST_OPS_PER_OBS * n_obs),
    }
    out = {}
    for kernel, (call, plain, library, nb, ops) in cases.items():
        k_ms = _time_ms(torch, call)
        dev_us = _device_us(torch, call, kernel + "_kernel", getattr(schur, kernel))
        p_ms = _time_ms(torch, plain, samples=5, inner=2)
        lib_ms = None if library is None else _time_ms(torch, library)
        bound, bound_by = _bound_ms(nb, ops)
        _log(f"time {kernel} (L {l}, W {w}, {n_obs} observations, {n_active} active "
             f"landmarks): call {k_ms * 1e3:.2f} us ({dev_us:.2f} us of it on the device), "
             f"plain {p_ms * 1e3:.1f} us, library "
             f"{'none' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, bound "
             f"{bound * 1e3:.4f} us ({bound_by})")
        out[kernel] = {"ms": k_ms, "device_ms": dev_us / 1e3, "plain_ms": p_ms,
                       "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}
    return out


def _pnp_calls(torch, cfg, frames, dev) -> list:
    """Phase 3f's inputs: ``(p3, uv, hyp_idx)`` of each PnP call (one per
    accepted frame) of ``frames`` streamed eagerly by a fresh engine on
    ``dev``."""
    from stereo_vo_tpu_torch.engine.step import VOEngine
    from stereo_vo_tpu_torch.frontend import pnp

    calls, core = [], pnp.pnp_ransac_core

    def recording(p3, uv, valid, cam, prev_pose, hyp_idx, fc):
        calls.append((p3.contiguous().clone(), uv.contiguous().clone(),
                      hyp_idx.contiguous().clone()))
        return core(p3, uv, valid, cam, prev_pose, hyp_idx, fc)

    engine = VOEngine(cfg, frames[0].left.shape, device=dev, graphs=False)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    pnp.pnp_ransac_core = recording
    try:
        for frame in frames[1:]:
            state, _ = engine.step(state, frame.left, frame.right)
    finally:
        pnp.pnp_ransac_core = core
    return calls


def _pnp_hyp_check(torch, cfg, frames, dev) -> dict:
    """Phase 3f: the PnP hypothesis kernel on the card against the plain
    version on the CPU, on the inputs of every PnP call of ``frames``
    (``hypothesis_hold`` with one-ulp nudged reruns of both), and before the
    polish bitwise the host build; at the first call its time (CUDA events),
    the plain version's on the card, the kernel's device time per launch
    (``torch.profiler``) and its bound. Returns the kernel's record."""
    import numpy as np

    from stereo_vo_tpu_torch.eval.parity import hypothesis_hold
    from stereo_vo_tpu_torch.frontend import pnp

    cam, polish = cfg.camera, cfg.frontend.pnp_hyp_polish_iters
    calls = _pnp_calls(torch, cfg, frames, dev)
    _check(len(calls) > 0, "phase 4's world runs PnP")
    total = {"calls": len(calls), "hypotheses": 0, "rounding_decided": 0, "max_diff": 0.0,
             "max_spread": 0.0}

    def nudged(x):
        return torch.nextafter(x, torch.full_like(x, float("inf")))

    for n, (p3, uv, idx) in enumerate(calls):
        p3_c, uv_c, idx_c = p3.cpu(), uv.cpu(), idx.cpu()

        def card(a, b, k):
            out = pnp.pnp_hypotheses(a.to(dev), b.to(dev), idx, cam, k)
            return tuple(t.cpu().numpy() for t in out)

        def plain(a, b, k):
            return tuple(t.numpy() for t in pnp.pnp_hypotheses_ref(a, b, idx_c, cam, k))

        pre = card(p3_c, uv_c, 0)
        host = tuple(t.numpy() for t in pnp.pnp_hypotheses_host(p3_c, uv_c, idx_c, cam, 0))
        same = ((pre[0].view(np.int32) == host[0].view(np.int32))
                | (np.isnan(pre[0]) & np.isnan(host[0])))
        bitwise = bool(same.all()) and bool(np.array_equal(pre[1], host[1]))
        p3_n, uv_n = nudged(p3_c), nudged(uv_c)
        rep = hypothesis_hold(card(p3_c, uv_c, polish), plain(p3_c, uv_c, polish),
                              card(p3_n, uv_n, polish), plain(p3_n, uv_n, polish),
                              PNP_POSE_TOL, PNP_SPREAD_FACTOR)
        _log(f"check pnp_hypotheses call {n} ({idx.shape[0]} samples of {p3.shape[0]} slots): "
             f"against the plain version {json.dumps(rep)}; before the polish bitwise the host "
             f"build: {bitwise}")
        _check(bitwise, f"pnp_hypotheses call {n}: before the polish, the host build's bits")
        _check(rep["failed"] == [], f"pnp_hypotheses call {n}: hypotheses {rep['failed']}")
        _check(rep["rounding_decided"] <= PNP_DECIDED_MAX * rep["n"],
               f"pnp_hypotheses call {n}: rounding decides {rep['rounding_decided']}")
        total["hypotheses"] += rep["n"]
        total["rounding_decided"] += rep["rounding_decided"]
        total["max_diff"] = max(total["max_diff"], rep["max_diff"])
        total["max_spread"] = max(total["max_spread"], rep["max_spread"])

    p3, uv, idx = calls[0]
    h = idx.shape[0]
    call = lambda: pnp.pnp_hypotheses(p3, uv, idx, cam, polish)
    k_ms = _time_ms(torch, call)
    dev_us = _device_us(torch, call, "pnp_hyp_kernel", pnp.pnp_hypotheses)
    p_ms = _time_ms(torch, lambda: pnp.pnp_hypotheses_ref(p3, uv, idx, cam, polish), samples=5,
                    inner=2)
    bound, bound_by = _bound_ms(h * PNP_BYTES_PER_HYP, h * (PNP_DLT_OPS + polish * PNP_POLISH_OPS))
    _log(f"time pnp_hypotheses ({h} samples, {polish} polish iterations): call "
         f"{k_ms * 1e3:.2f} us ({dev_us:.2f} us of it on the device), plain (torch ops on the "
         f"card) {p_ms * 1e3:.1f} us, bound {bound * 1e3:.4f} us ({bound_by}); over "
         f"{total['calls']} calls: {json.dumps(total)}")
    return {"ms": k_ms, "device_ms": dev_us / 1e3, "plain_ms": p_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None, "max_abs_err": total["max_diff"], **total}


def _detect_kernels(torch, cfg, img, dev) -> dict:
    """Phase 4b: the device kernels of one greedy ``detect_corners`` on
    ``img`` (the fixpoint, cap and pack in one launch) against the same
    detection with the cap and pack as the torch ops after a fixpoint-only
    launch (detection before the pack joined the kernel), both from
    ``torch.profiler``; bitwise the same outputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stereo_vo_tpu_torch.ops import shi_tomasi as st

    fc = cfg.frontend
    kw = dict(quality_level=fc.quality_level, min_distance=fc.min_distance,
              block_size=fc.detect_block_size)
    r2 = fc.min_distance * fc.min_distance
    resp = st.min_eig_response(img, fc.detect_block_size)

    def fused():
        return st.detect_corners(img, fc.max_detect, resp=resp, **kw)

    def separate():
        cxy, cvals = st.corner_candidates(img, resp=resp, **kw)
        cvalid = cvals > 0
        accepted = st.greedy_nms(cxy, cvalid, r2)
        rank = torch.cumsum(accepted.to(torch.int32), dim=0)
        accepted = accepted & (rank <= fc.max_detect)
        sel = torch.sort((~accepted).to(torch.uint8), stable=True).indices[:fc.max_detect]
        valid = accepted[sel]
        return cxy[sel], torch.where(valid, cvals[sel], -1.0), valid

    out = {}
    results = {}
    for label, fn in (("fused", fused), ("separate", separate)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            results[label] = fn()
            torch.cuda.synchronize()
        out[label] = sum(e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False))
    for g, w in zip(results["fused"], results["separate"]):
        _check(_bits_equal(torch, g, w), "detect_corners: the fused pack equals the torch ops")
    _check(out["fused"] < out["separate"],
           f"detect_corners: fewer device kernels with the pack in the kernel: {out}")
    return out


def _check_traced(what, traced, counted) -> None:
    """Each hand kernel's launches in a profiled stretch of the step graph
    equal its wrapper's count, read on the device; for ``LOOP_KERNELS``,
    between 1 and that count when it is not 0."""
    for kernel, n in counted.items():
        ok = (0 < traced[kernel] <= n if kernel in LOOP_KERNELS and n > 0
              else traced[kernel] == n)
        _check(ok, f"{what}: {kernel}: {n} counted launches, {traced[kernel]} in the trace")


def _check_streamed_steps(what, steps) -> None:
    """Each profiled streamed step (the step call and its summary fetch) is
    one graph launch with no kernel launch of its own and at most
    ``STEP_SYNCS_MAX`` syncs."""
    _check(bool(steps) and all(s["syncs"] <= STEP_SYNCS_MAX and s["graph_launches"] == 1
                               and s["launches"] == 0 for s in steps),
           f"{what}: per step syncs, graph and kernel launches "
           f"{[(s['syncs'], s['graph_launches'], s['launches']) for s in steps]}")


def _stream_profiled(torch, cfg, frames, dev, graphs):
    """Phase 4d's streamed run: ``frames`` streamed by a fresh engine; with
    ``graphs``, steps ``GRAPH_PROFILED`` under ``torch.profiler``; without,
    the windows that the bundle adjustments of the first four of those
    steps start from recorded. Returns ``(summaries, state, engine, prof or
    None, wrapper launches over those steps, keyframe flags there,
    [(window, compact), ...])``."""
    import contextlib

    from stereo_vo_tpu_torch.engine import step as step_module
    from stereo_vo_tpu_torch.engine.step import VOEngine
    from stereo_vo_tpu_torch.utils.profiling import (
        PORT_KERNELS,
        _step,
        device_trace,
        wrapper_launches,
    )

    engine = VOEngine(cfg, IMAGE_SHAPE, device=dev, graphs=graphs)
    state, out = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    rows, kf, windows = [out.summary.cpu()], [], []
    first, end = GRAPH_PROFILED
    solve = step_module.bundle_adjust

    def recording(window, cam, bcfg, compact=None):
        windows.append((window, compact))
        return solve(window, cam, bcfg, compact=compact)

    for i in range(1, first):
        state, out = engine.step(state, frames[i].left, frames[i].right)
        rows.append(out.summary.cpu())
    engine.flush_launches()
    before = wrapper_launches()
    with device_trace() if graphs else contextlib.nullcontext() as prof:
        for i in range(first, end):
            if not graphs and i < first + 4:
                step_module.bundle_adjust = recording
            try:
                state, vec, row = _step(engine, state, frames[i])
            finally:
                step_module.bundle_adjust = solve
            rows.append(torch.from_numpy(vec))
            kf.append(row["is_keyframe"])
    engine.flush_launches()
    after = wrapper_launches()
    counted = {k: after[k] - before[k] for k in PORT_KERNELS}
    return torch.stack(rows), state, engine, prof, counted, kf, windows


def _lm_stops(torch, cfg, frames, dev, windows) -> dict:
    """Phase 4d: no LM body runs after ``done``, and no build after a
    rejected step. On the windows the bundle adjustments of steps 8-11
    start from, each solve replayed as a graph program of its own
    (``utils.profiling.solve_program``) at the default ``max_lm_iters``
    against the same solve cut to its own ``it`` (the bodies that updated):
    device ms from ``torch.profiler`` within ``SOLVE_CUT_RTOL`` (or
    ``SOLVE_CUT_ATOL_MS``) of each other. Then the step graph's own counts,
    read on the device: a fresh graph engine streams the same frames, its
    counts read after each of steps 7-11; per step the WHILE node's trips
    against ``ceil(it / 2)`` and the builds (the solve's first, and one per
    run of the rebuild body) against ``1 + accepted``."""
    import dataclasses

    from stereo_vo_tpu_torch.engine.step import VOEngine
    from stereo_vo_tpu_torch.utils.profiling import (
        device_ms,
        elapsed_ms,
        lm_stop,
        solve_program,
    )

    rows = []
    for window, compact in windows:
        it, accepted = lm_stop(window, cfg.camera, cfg.backend, compact)
        cut = dataclasses.replace(cfg.backend, max_lm_iters=max(it, 1))
        full = solve_program(window, cfg.camera, cfg.backend, compact)
        to_it = solve_program(window, cfg.camera, cut, compact)
        rows.append({
            "compact": compact, "it": it, "accepted": accepted,
            "trips_want": (it + 1) // 2, "builds_want": 1 + accepted,
            "device_ms": device_ms(full), "device_ms_cut_to_it": device_ms(to_it),
            "elapsed_ms": elapsed_ms(full), "elapsed_ms_cut_to_it": elapsed_ms(to_it)})
    engine = VOEngine(cfg, IMAGE_SHAPE, device=dev)
    state, _ = engine.bootstrap(engine.init_state(), frames[0].left, frames[0].right)
    first = GRAPH_PROFILED[0]
    runs = []
    for i in range(1, first + len(windows)):
        state, _ = engine.step(state, frames[i].left, frames[i].right)
        if i >= first - 1:
            engine.flush_launches()
            program, = engine.programs.values()
            runs.append((dict(program.runs), _launches()))
    for row, (before, k_before), (after, k_after) in zip(rows, runs, runs[1:]):
        def ran(key):
            return after.get(key, 0) - before.get(key, 0)

        row.update(trips=ran("while:lm_pair"), builds=ran("if:_solve") + ran("if:rebuild"),
                   ba_launches={k: k_after[k] - k_before[k]
                                for k in ("ba_cost", "ba_build", "ba_damp_reduce", "ba_step")})
    _log("LM loops of steps 8-11: " + json.dumps(rows))
    for k, row in enumerate(rows):
        _check(row["trips"] == row["trips_want"] and row["builds"] == row["builds_want"],
               f"step {first + k}: {row['trips']} trips (ceil(it / 2) = {row['trips_want']}), "
               f"{row['builds']} builds (1 + accepted = {row['builds_want']})")
        want = {"ba_cost": 1, "ba_build": row["builds_want"],
                "ba_damp_reduce": 2 * row["trips_want"], "ba_step": 2 * row["trips_want"]}
        _check(row["ba_launches"] == want,
               f"step {first + k}: BA kernel launches {row['ba_launches']}, want {want}")
        slack = max(SOLVE_CUT_RTOL * row["device_ms_cut_to_it"], SOLVE_CUT_ATOL_MS)
        _check(abs(row["device_ms"] - row["device_ms_cut_to_it"]) <= slack,
               f"step {first + k}: the solve takes {row['device_ms']:.3f} device ms, cut to "
               f"its it {row['device_ms_cut_to_it']:.3f}")
    return {"solves": rows,
            "device_ms_median": statistics.median(r["device_ms"] for r in rows),
            "after_done_device_ms_median": statistics.median(
                r["device_ms"] - r["device_ms_cut_to_it"] for r in rows)}


def _graph_phase(torch, cfg, frames, dev) -> dict:
    """Phase 4d: the whole step as one graph program against the same step
    run eagerly (``graphs=False``): the 20-frame world streamed, every
    summary and the final state bitwise equal; steps ``GRAPH_PROFILED`` of
    each run under ``torch.profiler``: in the graph run each step one graph
    launch, no kernel launch and at most ``STEP_SYNCS_MAX`` syncs with its
    summary fetch, the wrappers' launches equal to the kernels in the trace,
    one BM and one NMS launch per keyframe; the step graph's WHILE node in
    the keyframe solve's body, with IF pairs in it; no LM body after
    ``done`` and no build after a rejected step (``_lm_stops``); then the
    129-frame world chunked by
    ``CHUNK`` with preload, graph against eager, every summary and the final
    state bitwise equal; and one profiled chunk (``profile_chunk``): no more
    than ``CHUNK_SYNCS_MAX`` syncs inside ``replay_chunk``, one graph launch
    per frame."""
    import numpy as np

    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.engine.graphs import flatten
    from stereo_vo_tpu_torch.engine.step import VOEngine
    from stereo_vo_tpu_torch.eval.parity import run_summaries
    from stereo_vo_tpu_torch.utils.profiling import _trace_counts, profile_chunk

    def same_state(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(flatten(a)[0], flatten(b)[0]))

    n = GRAPH_PROFILED[1] - GRAPH_PROFILED[0]
    g_rows, g_state, g_engine, g_prof, counted, kf, _ = _stream_profiled(
        torch, cfg, frames, dev, True)
    _phase("4d: the graph run streamed")
    e_rows, e_state, _, _, e_counted, _, windows = _stream_profiled(
        torch, cfg, frames, dev, False)
    _phase("4d: the eager run streamed")
    same_rows = int(sum(bool(torch.equal(a, b)) for a, b in zip(g_rows, e_rows)))
    same_final = same_state(g_state, e_state)
    trace = _trace_counts(g_prof, n, counted, kf)
    programs = {p.name: {"replays": p.replays, "conds": p.conds, "whiles": p.whiles,
                         "bodies": sorted(set(p.bodies))}
                for p in g_engine.programs.values()}
    out = {"frames": len(frames), "summaries_bitwise_equal": same_rows,
           "final_state_bitwise_equal": same_final, "programs": programs,
           "keyframes_profiled": sum(kf),
           "graphs": {k: v for k, v in trace.items() if k != "steps"},
           "graph_steps": trace["steps"], "eager_launches": e_counted,
           "lm_stops": _lm_stops(torch, cfg, frames, dev, windows)}
    _phase("4d: the LM loops' stops")
    _log("graph vs eager, 20-frame world streamed: " + json.dumps(out))
    _check(same_rows == len(frames), f"graph and eager summaries equal on {same_rows} frames")
    _check(same_final, "graph and eager final states bitwise equal")
    _check(len(programs) == 1, f"one step program for the streamed world: {programs}")
    bodies, = (p["bodies"] for p in programs.values())
    _check(("while", "lm_pair", 2) in bodies and ("if", "rebuild", 3) in bodies
           and ("else", "keep", 3) in bodies,
           f"a WHILE node in the keyframe solve's body, IF pairs in it: {bodies}")
    _check_streamed_steps("graph run, steps 8-19", trace["steps"])
    _check_traced("graph run, steps 8-19", trace["kernel_launches"], counted)
    _check(counted["stereo_bm_at_kernel"] == counted["greedy_nms_kernel"] == sum(kf) > 0,
           f"one BM and one NMS launch per profiled keyframe: {counted}")
    _check(np.isfinite(g_rows.numpy()).all(), "finite summaries")

    world = SyntheticStereoSequence(cam=cfg.camera, n_frames=N_REPLAY, shape=IMAGE_SHAPE,
                                    n_points=4000, seed=0, speed=0.8, yaw_rate=0.003)
    replay = list(world)
    runs = {}
    for graphs in (True, False):
        engine = VOEngine(cfg, IMAGE_SHAPE, device=dev, graphs=graphs)
        t0 = time.perf_counter()
        runs[graphs] = run_vo(iter(replay), cfg, chunk_size=CHUNK, preload_device=True,
                              engine=engine)
        _log(f"129-frame world chunked by {CHUNK}, graphs={graphs}: "
             f"{time.perf_counter() - t0:.2f} s, {runs[graphs].frames_per_sec:.3f} frames/s "
             f"after the first chunk, chunk s {runs[graphs].chunk_seconds}")
    g_sum, e_sum = run_summaries(runs[True]), run_summaries(runs[False])
    chunked = {"frames": len(g_sum),
               "summaries_bitwise_equal": int((g_sum == e_sum).all(axis=1).sum()),
               "final_state_bitwise_equal": same_state(runs[True].state, runs[False].state),
               "keyframes": int(g_sum[:, 7].sum())}
    _phase("4d: the chunked runs")
    chunk = profile_chunk(cfg, replay, CHUNK, dev)
    _phase("4d: the profiled chunk")
    chunked["profiled_chunk"] = chunk
    out["chunked"] = chunked
    _log("graph vs eager, 129-frame world chunked: " + json.dumps(chunked))
    _check(chunked["summaries_bitwise_equal"] == N_REPLAY,
           f"chunked graph and eager summaries equal on {chunked['summaries_bitwise_equal']}")
    _check(chunked["final_state_bitwise_equal"], "chunked graph and eager final states equal")
    _check(chunk["call"]["syncs"] <= CHUNK_SYNCS_MAX
           and chunk["call"]["graph_launches"] == CHUNK,
           f"replay_chunk: {chunk['call']} (syncs at most {CHUNK_SYNCS_MAX}, "
           f"{CHUNK} graph launches)")
    return out


def _geometry_phase(torch, dev) -> dict:
    """Phase 4c, the other shipped geometries: each of ``GEOMETRIES``'
    12-frame billboard worlds streamed through its own step graph (captured
    at its own shape, after phase 4's at 376x1241 in the same process) and
    held to its stored JAX run: frame by frame (flags and counts equal, the
    pose within ``GEOMETRY_TRAJ_TOL``), or, where the fixture holds the
    reference's nudged reruns, by the divergence rule; the launches exact;
    and the same world run eagerly, bitwise equal to the graph run."""
    import numpy as np

    from stereo_vo_tpu_torch.core.config import load_config
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.engine.step import VOEngine
    from stereo_vo_tpu_torch.eval.parity import divergence_hold, run_summaries

    out = {}
    for name, fixture in GEOMETRIES:
        ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), REF_DIR, fixture))
        cfg = load_config(name)
        shape = tuple(int(v) for v in ref["shape"])
        _check(str(ref["config"]) == name, f"{fixture} describes {ref['config']}")
        world = SyntheticStereoSequence(cam=cfg.camera, n_frames=int(ref["n_frames"]),
                                        shape=shape, n_points=int(ref["n_points"]),
                                        seed=int(ref["seed"]), speed=float(ref["speed"]),
                                        yaw_rate=float(ref["yaw_rate"]))
        frames = list(world)
        _zero_launches()
        run = run_vo(iter(frames), cfg, device=dev)
        launches = _launches()
        eager = run_vo(iter(frames), cfg, engine=VOEngine(cfg, shape, device=dev, graphs=False))
        got = run_summaries(run)
        what = f"{name} {shape[0]}x{shape[1]}"
        same = int((got == run_summaries(eager)).all(axis=1).sum())
        stats = run.frame_stats
        kf = np.array([st["is_keyframe"] for st in stats])
        steps = stats[int(np.argmax(kf)) + 1:]
        _check_launches(what, launches, _lk_passes(cfg, steps), int(kf.sum()), steps)
        programs = {p.name: p.replays for p in run.engine.programs.values()}
        if "spread_summaries" in ref:
            report = divergence_hold(got, ref["summaries"], ref["spread_summaries"],
                                     world.gt_poses, GEOMETRY_TRAJ_TOL, PHOTO_BA_RTOL,
                                     SPREAD_FACTOR, ATE_RTOL)
            _log(f"{what} vs {fixture} (divergence rule): "
                 + json.dumps({k: v for k, v in report.items() if k != "failures"},
                              default=float))
            failures = report["failures"]
            if name in GEOMETRY_ATE_UNHELD:
                unheld = [f for f in failures if f.startswith("keyframe ATE")]
                failures = [f for f in failures if f not in unheld]
                _log(f"{what}: the keyframe ATE band, printed and not held (PERF.md §7): "
                     f"{unheld or 'within it'}")
            _check(not failures, f"{what}: {failures}")
            out[name] = {"departure": report["frame"], "keyframes": report["keyframes"],
                         "ate": report["ate"]}
        else:
            out[name] = _hold_to_reference(what, run, fixture, GEOMETRY_TRAJ_TOL)
        out[name].update(programs=programs, graph_equals_eager=same)
        _log(f"{what}: step programs {programs}, graph and eager summaries equal on {same} of "
             f"{len(got)} frames")
        _check(len(programs) == 1, f"{what}: one step program, {programs}")
        _check(same == len(got), f"{what}: graph and eager equal on {same} of {len(got)}")
    return out


def _device_us(torch, fn, kernel, wrapper, calls=10, tries=4):
    """Device time per launch of ``kernel``, in us, from the self device time
    ``torch.profiler`` records over ``calls`` calls of ``fn``. ``wrapper`` is
    the kernel's wrapper: its launch count must rise by ``calls`` (or by 0,
    and then this returns 0: the call launches nothing). The time divides by
    the launches the trace holds; a trace that holds none of a call that
    launched is profiled again, at most ``tries`` times, and then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = wrapper.launches - before
        _check(launched in (0, calls), f"{kernel}: {launched} launches in {calls} profiled calls")
        if launched == 0:
            return 0.0
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel in e.key]
        traced = sum(e.count for e in events)
        if traced:
            dev_us = sum(e.self_device_time_total for e in events) / traced
            _check(dev_us > 0, f"{kernel}: {traced} traced launches with no device time")
            return dev_us
        _log(f"{kernel}: the trace holds none of its {launched} launches "
             f"(attempt {attempt + 1} of {tries})")
    _check(False, f"{kernel}: the profiler traced a launch in {tries} attempts")


def _time_ms(torch, fn, samples=20, inner=10):
    """Median over ``samples`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _hold_to_reference(what, run, name, tol) -> dict:
    """Phases 4c and 5: ``run`` frame by frame against the reference run
    stored in ``REF_DIR/name``; returns the largest pose differences."""
    import numpy as np

    from stereo_vo_tpu_torch.eval.parity import INT_KEYS, frame_differences, run_summaries

    ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), REF_DIR, name))
    d = frame_differences(run_summaries(run), ref["summaries"])
    for i in range(len(d["dq"])):
        ints = {k: int(d[k][i]) for k in INT_KEYS if d[k][i]}
        _log(f"{what} vs reference, frame {i}: |dq| {d['dq'][i]:.3g} |dt| {d['dt'][i]:.3g}"
             + (f" integer differences {json.dumps(ints)}" if ints else ""))
    out = {"max_dq": float(d["dq"].max()), "max_dt": float(d["dt"].max()),
           "frames_with_integer_differences": {k: int(np.count_nonzero(d[k])) for k in INT_KEYS},
           "max_ba_cost_rel": max(float(d["ba_initial_cost"].max()),
                                  float(d["ba_final_cost"].max()))}
    _log(f"{what} vs {name} (JAX {ref['jax_version']}, {len(d['dq'])} frames): "
         + json.dumps(out))
    for k in ("is_keyframe", "pnp_ok"):
        _check(not d[k].any(), f"{what}: {k} differs from the reference at frames "
                               f"{np.nonzero(d[k])[0].tolist()}")
    for k in ("num_tracked", "num_inliers"):
        _check(int(np.abs(d[k]).max()) <= COUNT_TOL, f"{what}: {k} differs by {d[k].tolist()}")
    _check(max(out["max_dq"], out["max_dt"]) <= tol, f"{what}: pose differs by {out} (tol {tol})")
    return out


def _sampler_check(torch, dev) -> dict:
    """Phase 4c: the PnP draw on the card, with no host sync, against the
    stored JAX indices."""
    import numpy as np

    from stereo_vo_tpu_torch.frontend.pnp import sample_hypotheses

    draws = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), REF_DIR,
                                 "pnp_draws.npz"))
    want = torch.from_numpy(draws["indices"].astype(np.int64))
    valid = torch.from_numpy(draws["valid"]).to(dev)
    n_draws, k = want.shape[1:]
    seeds = [int(s) for s in draws["seeds"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [sample_hypotheses(valid[i], n_draws, k, s) for i, s in enumerate(seeds)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host_ms = 1e3 * (time.perf_counter() - t0) / len(seeds)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / len(seeds)
    got = torch.stack(got).cpu()
    same = sum(bool(torch.equal(g, w)) for g, w in zip(got, want))
    out = {"masks": len(seeds), "draw": [n_draws, k], "bitwise_equal": same,
           "host_ms_per_draw": host_ms, "wall_ms_per_draw": wall_ms}
    _log(f"PnP draw on {dev} under sync-debug 'error' vs the stored JAX indices: "
         + json.dumps(out))
    _check(same == len(seeds), f"PnP draw equals the JAX indices on {same} of {len(seeds)}")
    return out


def _check_replay(cfg, run, gt_poses, out_dir, wall_s, launches) -> None:
    """Phase 5's checks on the chunked replay."""
    import numpy as np

    from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error

    stats = run.frame_stats
    kf = np.array([s["is_keyframe"] for s in stats])
    first_kf = int(np.argmax(kf))
    steps = stats[first_kf + 1:]
    hint = sum(s["hinted"] for s in steps) / max(len(steps), 1)
    kf_window = int(kf[KF_WINDOW[0]:KF_WINDOW[1]].sum())
    ate_kf = absolute_trajectory_error(run.poses[kf], gt_poses[kf], align=True)
    lk_passes = _lk_passes(cfg, steps)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    _log(f"chunked replay: {len(run.poses)} frames in {wall_s:.2f} s (incl. preload upload), "
         f"{run.frames_per_sec:.3f} frames/s after the first chunk, "
         f"chunk s {[round(c, 3) for c in run.chunk_seconds]}, "
         f"streamed step s {[round(t, 3) for t in run.frame_seconds]}, "
         f"preload misses {run.preload_misses}")
    _log(f"chunked replay: keyframes {int(kf.sum())}, {kf_window} of 16 over frames "
         f"{KF_WINDOW[0]}-{KF_WINDOW[1] - 1}, hint engagement {hint:.3f}, aligned keyframe "
         f"ATE rmse {ate_kf['rmse']:.4f} m, all-frames ATE rmse {run.ate['rmse']:.4f} m, "
         f"metrics rows {len(rows)}")
    _check(len(run.poses) == N_REPLAY, f"{len(run.poses)} poses")
    _check(bool(np.all(np.isfinite(run.poses))), "non-finite pose")
    _check(len(run.chunk_seconds) == (N_REPLAY - 1) // CHUNK, f"chunks {run.chunk_seconds}")
    _check(run.preload_misses == 0, f"{run.preload_misses} preload misses")
    _check(hint > HINT_MIN, f"hint engagement {hint}")
    _check(KF_WINDOW_RANGE[0] <= kf_window <= KF_WINDOW_RANGE[1],
           f"{kf_window} keyframes over frames {KF_WINDOW}")
    _check(ate_kf["rmse"] < REPLAY_ATE_BOUND_M, f"keyframe ATE {ate_kf}")
    _check(len(rows) == N_REPLAY and [r["frame"] for r in rows] == list(range(N_REPLAY)),
           f"{len(rows)} metrics rows")
    _check_launches("chunked replay", launches, lk_passes, int(kf.sum()), steps)
    _check(os.path.exists(os.path.join(out_dir, "checkpoint.npz")), "no checkpoint written")
    _hold_to_reference("chunked replay", run, "kitti00_w129_c64.npz", REPLAY_TRAJ_TOL_CARD)


def _photo_world_phase(cfg, dev) -> dict:
    """Phase 5b: ``run_vo(chunk_size=PHOTO_CHUNK, preload_device=True)`` over
    each seed of the photo world, launches counted exactly, held to its
    stored JAX run by the divergence rule; returns the launches per seed."""
    import numpy as np

    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence, load_sample_photo
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.eval.parity import (
        INT_KEYS,
        divergence_hold,
        frame_differences,
        run_summaries,
    )

    launches = {}
    for seed in PHOTO_SEEDS:
        name = f"kitti00_photo_s{seed}_w161_c32.npz"
        ref = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), REF_DIR, name))
        world = SyntheticStereoSequence(cam=cfg.camera, shape=IMAGE_SHAPE, seed=seed,
                                        texture=load_sample_photo(), **PHOTO_WORLD)
        t0 = time.perf_counter()
        frames = list(world)
        render_s = time.perf_counter() - t0
        _zero_launches()
        t0 = time.perf_counter()
        run = run_vo(iter(frames), cfg, chunk_size=PHOTO_CHUNK, preload_device=True, device=dev)
        wall_s = time.perf_counter() - t0
        launches[f"photo_world_s{seed}"] = counts = _launches()
        stats = run.frame_stats
        kf = np.array([s["is_keyframe"] for s in stats])
        steps = stats[int(np.argmax(kf)) + 1:]
        what = f"photo world seed {seed}"
        _log(f"{what}: {len(frames)} frames rendered in {render_s:.2f} s, run in {wall_s:.2f} s "
             f"(incl. preload upload), {run.frames_per_sec:.3f} frames/s after the first chunk")
        _check_launches(what, counts, _lk_passes(cfg, steps), int(kf.sum()), steps)
        got = run_summaries(run)
        _check(got.shape == ref["summaries"].shape and bool(np.isfinite(got).all()),
               f"{what}: summaries {got.shape}")
        d = frame_differences(got, ref["summaries"])
        for i in range(len(got)):
            ints = {k: int(d[k][i]) for k in INT_KEYS if d[k][i]}
            _log(f"{what} vs reference, frame {i}: |dq| {d['dq'][i]:.3g} |dt| {d['dt'][i]:.3g} "
                 f"BA costs {d['ba_initial_cost'][i]:.3g} {d['ba_final_cost'][i]:.3g}"
                 + (f" integer differences {json.dumps(ints)}" if ints else ""))
        report = divergence_hold(got, ref["summaries"], ref["spread_summaries"], world.gt_poses,
                                 TRAJ_TOL_PHOTO_CARD, PHOTO_BA_RTOL, SPREAD_FACTOR, ATE_RTOL)
        held = len(got) if report["frame"] is None else report["frame"]
        exact_pose = float(np.maximum(d["dq"], d["dt"])[:held].max()) if held else 0.0
        _log(f"{what} vs {name} (JAX {ref['jax_version']}): frames held exactly 0-{held - 1} "
             f"(largest pose difference there {exact_pose:.3g}); "
             + json.dumps({k: v for k, v in report.items() if k != "failures"}, default=float))
        _check(not report["failures"], f"{what}: {report['failures']}")
        _check(int(kf.sum()) >= PHOTO_MIN_KEYFRAMES, f"{what}: {int(kf.sum())} keyframes")
    return launches


def _check_cli(out_dir: str, dev) -> None:
    """Phase 7: the CLI in a child process on the real fixtures, with cv2,
    PIL and matplotlib unimportable in it."""
    import numpy as np

    repo = os.path.dirname(os.path.abspath(__file__))
    args = ["run", "--config", REAL_CONFIG, "--kitti-root", os.path.join(repo, REAL_ROOT),
            "--sequence", REAL_SEQUENCE, "--device", str(dev), "--out", out_dir,
            "--save-world-points", "--save-track-images", "2", "--quiet"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", HIDE_HOST_LIBS, *args], cwd=repo,
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    _check(proc.returncode == 0, f"cli run exit {proc.returncode}: {proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    files = sorted(os.listdir(out_dir))
    points = sorted(os.listdir(os.path.join(out_dir, "world_points")))
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        n_rows = sum(1 for _ in f)
    tracks = [f"tracks_{i:06d}.png.npy" for i in range(0, REAL_FRAMES, 2)]
    _log(f"cli on real imagery: {wall_s:.2f} s (child process, incl. start-up), "
         f"summary {json.dumps(summary)}")
    _log(f"cli on real imagery: files {files}, world_points {points}")
    _check(summary["frames"] == REAL_FRAMES, f"cli summary {summary}")
    _check(summary["ate"] is not None and summary["ate"]["rmse"] < REAL_ATE_BOUND_M,
           f"real-imagery ATE {summary['ate']}")
    _check(n_rows == REAL_FRAMES, f"{n_rows} metrics rows")
    for name in ("trajectory_kitti.txt", "trajectory_tum.txt", *tracks):
        _check(name in files, f"cli output {name} missing from {files}")
    _check(bool(points), "no world-points dump")
    img = np.load(os.path.join(out_dir, tracks[0]))
    _check(img.shape == IMAGE_SHAPE + (3,) and img.dtype == np.uint8, f"track image {img.shape}")

    proc = subprocess.run([sys.executable, "-c", HIDE_HOST_LIBS, *args, "--plot"], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    _log(f"cli --plot without matplotlib: exit {proc.returncode}, "
         f"stderr {proc.stderr.strip()[-200:]!r}")
    _check(proc.returncode != 0 and "matplotlib" in proc.stderr, "--plot without matplotlib")


def _in_child(fn: str) -> dict:
    """``fn()`` of this module run in a child process on the card (the
    kernels built by this one are reused from the build directory); its
    last line of output, a JSON object."""
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", f"import chip_smoke; chip_smoke.{fn}()"],
                          cwd=repo, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        _log(line)
    _check(proc.returncode == 0, f"{fn} in a child process: exit {proc.returncode}: "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def _child_setup():
    """A child process's torch, settings, kitti00 config and device."""
    import torch

    from stereo_vo_tpu_torch.core.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch, load_config("kitti00"), torch.device("cuda:0")


def _main_world(cfg, n_frames=N_FRAMES):
    """Phase 4's world (and phase 5's at ``N_REPLAY`` frames)."""
    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence

    return SyntheticStereoSequence(cam=cfg.camera, n_frames=n_frames, shape=IMAGE_SHAPE,
                                   n_points=4000, seed=0, speed=0.8, yaw_rate=0.003)


def _keyframe_profile_child() -> None:
    """Phase 4b's profile (``utils.profiling.profile_keyframes`` on phase
    4's world), printed as one JSON line."""
    from stereo_vo_tpu_torch.utils.profiling import profile_keyframes

    torch, cfg, dev = _child_setup()
    print(json.dumps(profile_keyframes(cfg, list(_main_world(cfg)), dev)), flush=True)


def _graph_phase_child() -> None:
    """Phase 4d (``_graph_phase`` on phase 4's world), its record printed
    as one JSON line."""
    torch, cfg, dev = _child_setup()
    print(json.dumps(_graph_phase(torch, cfg, list(_main_world(cfg)), dev)), flush=True)


def _step_parts_child() -> None:
    """Phase 4d's split of a keyframe step's device time
    (``utils.profiling.profile_step_parts``: the eager step, every kernel in
    the trace), printed as one JSON line."""
    from stereo_vo_tpu_torch.utils.profiling import profile_step_parts

    torch, cfg, dev = _child_setup()
    print(json.dumps(profile_step_parts(cfg, list(_main_world(cfg)), dev)), flush=True)


def _profile_replay_child() -> None:
    """Phase 6b's profile (``utils.profiling.profile_replay`` on the
    129-frame world), printed as one JSON line."""
    from stereo_vo_tpu_torch.utils.profiling import profile_replay

    _, cfg, dev = _child_setup()
    print(json.dumps(profile_replay(cfg, list(_main_world(cfg, N_REPLAY)), dev)), flush=True)


def _offline_phases(cfg, dev) -> dict:
    """Phases 5-7; returns the kernel launches of phases 5 and 6."""
    import numpy as np

    from stereo_vo_tpu_torch.data.synthetic import SyntheticStereoSequence
    from stereo_vo_tpu_torch.engine.driver import run_vo

    phase_launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- 5. chunked replay with device preload
        _phase("5")
        world = SyntheticStereoSequence(
            cam=cfg.camera, n_frames=N_REPLAY, shape=IMAGE_SHAPE, n_points=4000, seed=0,
            speed=0.8, yaw_rate=0.003,
        )
        t0 = time.perf_counter()
        frames = list(world)
        _log(f"replay world: {len(frames)} frames rendered in {time.perf_counter() - t0:.2f} s")
        out5 = os.path.join(tmp, "replay")
        _zero_launches()
        t0 = time.perf_counter()
        run5 = run_vo(iter(frames), cfg, chunk_size=CHUNK, preload_device=True, out_dir=out5,
                      checkpoint_every=CKPT_EVERY, device=dev)
        wall_s = time.perf_counter() - t0
        phase_launches["chunked_replay"] = _launches()
        _check_replay(cfg, run5, world.gt_poses, out5, wall_s, phase_launches["chunked_replay"])

        # ---- 6. resume from phase 5's checkpoint
        _phase("6")
        ckpt = os.path.join(out5, "checkpoint.npz")
        _zero_launches()
        t0 = time.perf_counter()
        run6 = run_vo(iter(frames), cfg, chunk_size=CHUNK, preload_device=True,
                      resume_from=ckpt, device=dev)
        wall_s = time.perf_counter() - t0
        phase_launches["resume"] = _launches()
        idx = [s["frame"] for s in run6.frame_stats]
        first_err = float(np.abs(run6.poses[0] - run5.poses[CKPT_EVERY]).max())
        all_err = float(np.abs(run6.poses - run5.poses[CKPT_EVERY:]).max())
        kf_same = sum(a["is_keyframe"] == b["is_keyframe"]
                      for a, b in zip(run6.frame_stats, run5.frame_stats[CKPT_EVERY:]))
        _log(f"resume: {len(run6.poses)} frames ({idx[0]}-{idx[-1]}) in {wall_s:.2f} s, "
             f"chunk s {[round(c, 3) for c in run6.chunk_seconds]}, "
             f"max |pose - straight| first {first_err:.3g} all {all_err:.3g}, "
             f"keyframe flags equal on {kf_same} of {len(run6.frame_stats)}")
        _check_launches("resume", phase_launches["resume"], _lk_passes(cfg, run6.frame_stats),
                        sum(st["is_keyframe"] for st in run6.frame_stats), run6.frame_stats)
        _check(idx == list(range(CKPT_EVERY, N_REPLAY)), f"resumed frames {idx[:3]}..{idx[-3:]}")
        _check(bool(np.all(np.isfinite(run6.poses))), "non-finite resumed pose")
        _check(first_err < RESUME_TOL, f"first resumed pose differs by {first_err}")

        # ---- 6b. where a frame's time goes: frames 65-72 of the same world,
        # streamed, under torch.profiler, in a fresh process (a long process's
        # profiler drops kernels of the graph's conditional bodies)
        _phase("6b")
        prof = _in_child("_profile_replay_child")
        _log("profile, frames 65-72 streamed: " + json.dumps(prof))
        _check(prof["kernel_launches"]["lk_level_kernel"] > 0,
               "the profiled frames ran the LK kernel")
        _check_streamed_steps("frames 65-72", prof["steps"])

        # ---- 5b. the photo-textured long-horizon world, both seeds
        _phase("5b")
        phase_launches.update(_photo_world_phase(cfg, dev))

        # ---- 7. the CLI on real imagery, without cv2, PIL and matplotlib
        _phase("7")
        _check_cli(os.path.join(tmp, "cli"), dev)
    return phase_launches


def _dense_bm_check(torch, cfg, label, left, right, dev) -> None:
    """Phase 8a on one stereo pair (uint8 numpy images)."""
    from stereo_vo_tpu_torch.frontend.detect import detect_features
    from stereo_vo_tpu_torch.frontend.triangulate import (
        triangulate_features,
        triangulate_from_disparities,
    )
    from stereo_vo_tpu_torch.ops.stereo_bm import disparity_at, stereo_bm_at, stereo_bm_disparity

    fc = cfg.frontend
    kw = dict(num_disparities=fc.bm_num_disparities, block_size=fc.bm_block_size)
    lt = torch.from_numpy(left).to(dev).to(torch.float32)
    rt = torch.from_numpy(right).to(dev).to(torch.float32)
    dense = stereo_bm_disparity(lt, rt, **kw)
    xy, valid = detect_features(lt, fc)
    sparse = stereo_bm_at(lt, rt, xy, valid, **kw)
    at = torch.where(valid, disparity_at(dense, xy), -1.0)
    same_valid = bool(torch.equal(at > 0, sparse > 0))
    err = float((at - sparse).abs().max())
    ms = _time_ms(torch, lambda: stereo_bm_disparity(lt, rt, **kw), samples=5, inner=3)
    share = float((dense > 0).float().mean())
    _log(f"dense BM {label}: {tuple(dense.shape)}, valid share {share:.4f}, "
         f"{int(valid.sum())} corners ({int((sparse > 0).sum())} with a disparity), "
         f"max |dense - sparse| {err:.3g}, {ms:.3f} ms per call (sparse {int(valid.sum())} "
         f"corners: {_time_ms(torch, lambda: stereo_bm_at(lt, rt, xy, valid, **kw), 5, 3):.3f} ms)")
    _check(dense.shape == lt.shape and same_valid and err <= BM_TOL,
           f"dense BM {label} equals sparse BM at the corners")
    _check(share > 0.05, f"dense BM {label} valid share {share}")
    # the dense map triangulated at the corners, against the sparse path's
    # points at the same corners
    pose = torch.tensor([0.99, 0.05, -0.08, 0.1, 0.4, -0.2, 1.5], device=dev)
    pose[:4] = pose[:4] / torch.linalg.vector_norm(pose[:4])
    p_dense, ok_dense = triangulate_features(dense, xy, valid, cfg.camera, pose)
    p_sparse, ok_sparse = triangulate_from_disparities(sparse, xy, valid, cfg.camera, pose)
    p_err = float(((p_dense - p_sparse).abs() / p_sparse.abs().clamp(min=1.0)).max())
    _log(f"triangulate_features {label}: {int(ok_dense.sum())} points from the dense map, "
         f"validity equal to the sparse path's: {bool(torch.equal(ok_dense, ok_sparse))}, "
         f"max relative |dense - sparse| {p_err:.3g}")
    _check(torch.equal(ok_dense, ok_sparse) and int(ok_dense.sum()) > 0 and p_err <= TRI_RTOL,
           f"triangulate_features {label} agrees with the sparse path")


def _forward_tracking(torch, cfg, world, dev) -> int:
    """Phase 8b; returns the kernel launches of the forward-only steps."""
    from stereo_vo_tpu_torch.frontend.detect import detect_features
    from stereo_vo_tpu_torch.frontend.track import track_step, tracker_init
    from stereo_vo_tpu_torch.ops.pyramid import build_pyramid

    fc = cfg.frontend
    f_cap = cfg.backend.feature_capacity
    pyrs = [build_pyramid(torch.from_numpy(world.render(i)[0]).to(dev), fc.lk_max_level)
            for i in range(N_FRAMES)]
    states = []
    for t in range(N_FRAMES - 1):
        xy, valid = detect_features(pyrs[t][0], fc)
        n = xy.shape[0]
        xy_f = torch.zeros((f_cap, 2), dtype=torch.float32, device=dev)
        valid_f = torch.zeros(f_cap, dtype=torch.bool, device=dev)
        xy_f[:n], valid_f[:n] = xy, valid
        ids = torch.arange(f_cap, dtype=torch.int32, device=dev)
        states.append(tracker_init(tuple(pyrs[t]), xy_f, ids, valid_f))

    def run(flow_back):
        kept, ms = [], []
        for t, st in enumerate(states):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, stats = track_step(st, tuple(pyrs[t + 1]), fc, flow_back=flow_back)
            kept.append(int(stats.num_tracked))
            ms.append(1e3 * (time.perf_counter() - t0))
        return kept, ms

    _zero_launches()
    kept_fwd, ms_fwd = run(False)
    launches = _launches()
    kept_fb, ms_fb = run(True)
    levels = fc.lk_max_level + 1
    _log(f"forward-only tracking: kept {kept_fwd}, median {statistics.median(kept_fwd)}, "
         f"step ms p50 {statistics.median(ms_fwd):.1f} max {max(ms_fwd):.1f}")
    _log(f"fwd/bwd tracking, same pairs: kept {kept_fb}, median {statistics.median(kept_fb)}, "
         f"step ms p50 {statistics.median(ms_fb):.1f} max {max(ms_fb):.1f}")
    _check_launches(f"forward-only tracking, {levels} levels x {len(states)} pairs", launches,
                    levels * len(states), 0)
    _check(statistics.median(kept_fwd) > 50, f"forward-only kept {kept_fwd}")
    return launches


def _maxpool_check(torch, cfg, world, dev) -> None:
    """Phase 8c on frame 0 of phase 4's world."""
    from stereo_vo_tpu_torch.ops.shi_tomasi import detect_corners

    fc = cfg.frontend
    img = torch.from_numpy(world.render(0)[0]).to(dev).to(torch.float32)
    kw = dict(max_corners=fc.max_detect, quality_level=fc.quality_level,
              min_distance=fc.min_distance, block_size=fc.detect_block_size)
    xy, _, valid = detect_corners(img, nms="maxpool", **kw)
    greedy = int(detect_corners(img, **kw)[2].sum())
    pts = xy[valid]
    d = torch.cdist(pts, pts) + torch.eye(len(pts), device=dev) * 1e9
    n, dmin = int(valid.sum()), float(d.min())
    _log(f"maxpool detection: {n} corners against {greedy} greedy ({n / greedy:.3f}), "
         f"closest pair {dmin:.1f} px (min_distance {fc.min_distance})")
    _check(MAXPOOL_RANGE[0] * greedy <= n <= MAXPOOL_RANGE[1] * greedy, "maxpool count")
    _check(dmin >= fc.min_distance, f"maxpool corners {dmin} px apart")


def _f64_island(torch, world, run4, dev, tmp) -> None:
    """Phase 8d: ``run_vo`` with the f64 island set in a YAML."""
    import numpy as np

    from stereo_vo_tpu_torch.backend.schur import reduced_camera_condition, window_to_landmark_major
    from stereo_vo_tpu_torch.core.config import CONFIG_DIR, load_config
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error

    with open(os.path.join(CONFIG_DIR, "kitti00.yaml")) as f:
        text = f.read()
    path = os.path.join(tmp, "kitti00_f64.yaml")
    with open(path, "w") as f:
        f.write(text + "\nbackend:\n  reduced_solve_f64: true\n")
    cfg = load_config(path)
    _check(cfg.backend.reduced_solve_f64, "the YAML sets reduced_solve_f64")
    run = run_vo(world, cfg, device=dev)
    kf = np.array([s["is_keyframe"] for s in run.frame_stats])
    ate = absolute_trajectory_error(run.poses[kf], world.gt_poses[kf], align=True)
    first_kf = int(np.argmax(kf))
    step_ms = [1e3 * t for t in run.frame_seconds[first_kf + 1:]]
    diff = float(np.abs(run.poses - run4.poses).max())
    window = run.state.window
    cond = float(reduced_camera_condition(window_to_landmark_major(window), cfg.camera,
                                          cfg.backend))
    _log(f"f64 island: {len(run.poses)} frames, keyframes {int(kf.sum())}, aligned keyframe "
         f"ATE rmse {ate['rmse']:.4f} m (bound {ATE_BOUND_M} m), step ms p50 "
         f"{statistics.median(step_ms):.1f}, max |pose - phase 4| {diff:.3g}, condition "
         f"number of the last window {cond:.4g}")
    _check(len(run.poses) == N_FRAMES and bool(np.all(np.isfinite(run.poses))), "f64 poses")
    _check(ate["rmse"] < ATE_BOUND_M, f"f64 keyframe ATE {ate}")
    _check(np.isfinite(cond) and cond > 1.0, f"condition number {cond}")


def _sharded_phases(torch, tmp) -> None:
    """Phase 9: one NCCL rank in this process, then four gloo ranks."""
    import numpy as np
    import torch.distributed as dist

    from stereo_vo_tpu_torch.backend import schur
    from stereo_vo_tpu_torch.backend.window import WindowState
    from stereo_vo_tpu_torch.core.camera import CameraInfo
    from stereo_vo_tpu_torch.core.config import BackendConfig
    from stereo_vo_tpu_torch.parallel import make_mesh, sharded_bundle_adjust
    from stereo_vo_tpu_torch.parallel.dryrun import dryrun_multichip, make_lm_problem

    # ---- 9a. one NCCL rank: a 5 x 2048 window, every landmark seen by every pose
    dev = torch.device("cuda", 0)
    cam = CameraInfo(focal=718.856, cx=607.19, cy=185.22, baseline=0.537)
    w, lcap = 5, 2048
    cfg = BackendConfig(window_size=w, landmark_capacity=lcap, feature_capacity=lcap,
                        max_lm_iters=10)
    p = make_lm_problem(w, lcap, cam)
    window = WindowState(
        poses=p.poses, pose_valid=p.pose_valid, obs_uv=p.obs_uv.transpose(1, 0, 2).copy(),
        obs_lm=np.tile(np.arange(lcap, dtype=np.int32), (w, 1)),
        obs_valid=p.obs_valid.T.copy(), lm_pos=p.lm_pos,
        lm_refcount=np.full(lcap, w, np.int32), lm_valid=p.lm_valid, lm_prior=p.lm_prior,
        lm_prior_w=p.lm_prior_w, num_kf=np.int32(w))
    window = WindowState(*[None if x is None else torch.as_tensor(x).to(dev) for x in window])
    single, stats = schur.bundle_adjust(window, cam, cfg)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "nccl_store"),
                            world_size=1, rank=0)
    try:
        t0 = time.perf_counter()
        sharded, c0, c1 = sharded_bundle_adjust(window, cam, cfg, make_mesh((1,), ("lm",), "cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    pose_err = float((sharded.poses - single.poses).abs().max())
    lm_err = float((sharded.lm_pos - single.lm_pos).abs().max())
    _log(f"sharded BA, 1 NCCL rank, {w}x{lcap}: cost {float(c0):.4f} -> {float(c1):.4f} "
         f"(single {float(stats.initial_cost):.4f} -> {float(stats.final_cost):.4f}), max "
         f"|sharded - single| poses {pose_err:.3g} landmarks {lm_err:.3g}, {wall:.3f} s")
    _check(pose_err <= SHARD_POSE_TOL and lm_err <= SHARD_LM_TOL, "NCCL sharded == single")
    _check(float(c1) < float(c0), "NCCL sharded solve lowers the cost")

    # ---- 9b. four gloo ranks on cuda:0
    t0 = time.perf_counter()
    summary = dryrun_multichip(4, "cuda", timeout=600, store_dir=tmp)
    _log(f"dryrun_multichip(4, 'cuda'): {time.perf_counter() - t0:.1f} s, "
         + json.dumps(summary))
    for tag, row in summary["shapes"].items():
        _check(sorted(row["shards"]) == [1, 2, 4], f"{tag} shard counts {row['shards']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from stereo_vo_tpu_torch import cuda_build
    from stereo_vo_tpu_torch.core.config import load_config
    from stereo_vo_tpu_torch.data.synthetic import (
        SAMPLE_PHOTO,
        SyntheticStereoSequence,
        load_sample_photo,
    )
    from stereo_vo_tpu_torch.engine.driver import run_vo
    from stereo_vo_tpu_torch.eval.ate import absolute_trajectory_error

    # ---- 1. device, and the conditional nodes the step graph is built of
    _phase("1")
    smi = _nvidia_smi()
    _log(f"nvidia-smi: {smi}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    _conditional_probe(torch, dev)
    photo = load_sample_photo()
    _check(photo is not None and photo.shape == (600, 512), "the photo texture loads")
    _log(f"photo texture {os.path.basename(SAMPLE_PHOTO)}: {photo.shape} {photo.dtype}, "
         f"matplotlib importable: {importlib.util.find_spec('matplotlib') is not None}")

    # ---- 2. build
    _phase("2")
    _build_all(cuda_build, ("extract_regions", "lk_level", "stereo_bm_at", "greedy_nms",
                            "ba_lm", "pnp_hyp", "graph_cond"))

    # ---- 3. the region-extraction kernel against its plain version
    _phase("3")
    max_err, timings = _extraction_check(torch, dev)

    # ---- 3b. the LK level-pass kernel against its plain version
    _phase("3b")
    cfg = load_config("kitti00")
    world = SyntheticStereoSequence(
        cam=cfg.camera, n_frames=N_FRAMES, shape=IMAGE_SHAPE, n_points=4000, seed=0,
        speed=0.8, yaw_rate=0.003,
    )
    lk_record = _lk_level_check(torch, cfg, world, dev)
    _lk_inactive_check(torch, cfg, world, dev)
    lk_record["max_abs_err"] = max(lk_record["max_abs_err"], _fast_motion_check(torch, dev))

    # ---- 3c. the sparse StereoBM kernel against its plain version
    _phase("3c")
    from stereo_vo_tpu_torch.data.kitti import KittiSequence

    world_frames = list(world)
    real = KittiSequence(os.path.join(os.path.dirname(os.path.abspath(__file__)), REAL_ROOT),
                         REAL_SEQUENCE)
    bm_record = _bm_kernel_check(torch, cfg, [("synthetic", *world_frames[:2]),
                                              ("real", real[0], real[1])], dev)

    # ---- 3d. the greedy-NMS kernel against its plain version
    _phase("3d")
    photo_world = SyntheticStereoSequence(cam=cfg.camera, shape=IMAGE_SHAPE, seed=PHOTO_SEEDS[0],
                                          texture=photo, **PHOTO_WORLD)
    photo0 = photo_world.render(0)[0]
    nms_record = _nms_check(torch, cfg, world, photo0, dev)

    # ---- 3e. the bundle adjustment's kernels against their plain versions
    _phase("3e")
    ba_records = _ba_check(torch, cfg, world_frames, dev)

    # ---- 3f. the PnP hypothesis kernel against its plain version
    _phase("3f")
    pnp_record = _pnp_hyp_check(torch, cfg, world_frames, dev)

    # ---- 4. the main path
    _phase("4")
    _zero_launches()
    t0 = time.perf_counter()
    run = run_vo(world, cfg, device=dev)
    wall_s = time.perf_counter() - t0
    launches = _launches()

    stats = run.frame_stats
    for s in stats:
        _log("frame " + json.dumps(s))
    kf = np.array([s["is_keyframe"] for s in stats])
    first_kf = int(np.argmax(kf))
    steps = stats[first_kf + 1:]
    lk_passes = _lk_passes(cfg, steps)
    ate_kf = absolute_trajectory_error(run.poses[kf], world.gt_poses[kf], align=True)
    step_ms = [1e3 * t for t in run.frame_seconds[first_kf + 1:]]
    _log(f"main path: {len(run.poses)} frames in {wall_s:.2f} s (incl. rendering), "
         f"{run.frames_per_sec:.2f} frames/s after the first step, "
         f"step ms p50 {statistics.median(step_ms):.1f} max {max(step_ms):.1f}")
    _log(f"keyframes {int(kf.sum())}, aligned keyframe ATE rmse {ate_kf['rmse']:.4f} m "
         f"(bound {ATE_BOUND_M} m), all-frames ATE rmse {run.ate['rmse']:.4f} m")

    _check(len(run.poses) == N_FRAMES, f"{len(run.poses)} poses")
    _check(bool(np.all(np.isfinite(run.poses))), "non-finite pose")
    _check(int(kf[first_kf + 1:].sum()) >= 2, "fewer than 2 keyframes after bootstrap")
    tracked = [s["num_tracked"] for s in steps]
    _check(statistics.median(tracked) > 50, f"median tracked count of {tracked}")
    _check(all(s["pnp_ok"] for s in stats), "PnP failed on an accepted frame")
    _check_launches("main path", launches, lk_passes, int(kf.sum()), steps)
    _check(ate_kf["rmse"] < ATE_BOUND_M, f"keyframe ATE {ate_kf}")
    phase_launches = {"main_path": launches}

    # ---- 4b. where a keyframe step's time goes: steps 8-11 of the same world,
    # and the Shi-Tomasi response on a photo frame (bitwise the CPU's; its
    # device time per frame against the former formula's)
    _phase("4b")
    prof = _in_child("_keyframe_profile_child")
    _log("profile, keyframe steps 8-11 streamed: " + json.dumps(prof))
    _log(f"device kernels per keyframe step (steps 8-11): {prof['keyframe_step']['kernels']}")
    det = _detect_kernels(torch, cfg, torch.from_numpy(world_frames[0].left).to(dev).to(
        torch.float32), dev)
    _log(f"device kernels of one greedy detect_corners on frame 0: {det['fused']} with the cap "
         f"and pack in the NMS kernel, {det['separate']} with them as torch ops after it "
         f"(the pack's launches: {det['separate'] - det['fused']})")
    _response_check(torch, photo0, dev)
    bm_traced = prof["kernel_launches"]["stereo_bm_at_kernel"]
    _check(prof["keyframes_profiled"] > 0 and bm_traced == prof["keyframes_profiled"],
           f"the profiled keyframe steps ran the BM kernel once each: {bm_traced}")
    _check(prof["kernel_launches"]["extract_regions_kernel"] == 0, "no region extraction")
    _check_traced("keyframe steps 8-11", prof["kernel_launches"], prof["wrapper_launches"])
    _check_streamed_steps("keyframe steps 8-11", prof["steps"])

    # ---- 4c. phase 4's run and the PnP draw held to the JAX package's, and
    # a second geometry through its own step graph
    _phase("4c")
    _hold_to_reference("main path", run, "kitti00_w20.npz", TRAJ_TOL_CARD)
    _sampler_check(torch, dev)
    _geometry_phase(torch, dev)

    # ---- 4d. the step graph against the same step run eagerly
    _phase("4d")
    _in_child("_graph_phase_child")
    parts = _in_child("_step_parts_child")
    _log("keyframe steps 8-11 of phase 4's world run eagerly, device ms and kernels by part: "
         + json.dumps(parts))
    _check(parts["keyframe_steps"] > 0 and all(parts[p]["kernels"] > 0
                                               for p in ("detect", "bm", "pnp", "ba")),
           f"every part of a keyframe step ran kernels: {parts}")

    phase_launches.update(_offline_phases(cfg, dev))

    # ---- 8. single-device options
    _phase("8")
    _dense_bm_check(torch, cfg, "real pair 0", real[0].left, real[0].right, dev)
    _dense_bm_check(torch, cfg, "synthetic frame 0", *world.render(0), dev)
    phase_launches["forward_only_tracking"] = _forward_tracking(torch, cfg, world, dev)
    _maxpool_check(torch, cfg, world, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        _f64_island(torch, world, run, dev, tmp)
        # ---- 9. the landmark-sharded BA
        _phase("9")
        _sharded_phases(torch, tmp)

    _log("launches per phase: " + json.dumps(phase_launches)
         + " (phase 7 runs in a child process: not counted)")

    def total(name):
        return sum(p[name] for p in phase_launches.values())

    print(json.dumps({"kernels": [{
        "name": "extract_regions",
        "route": "cuda",
        "source": "stereo_vo_tpu_torch/csrc/extract_regions.cu",
        "replaces": "stereo_vo_tpu/ops/pallas_extract.py:107 and :168",
        "launches": total("extract_regions"),
        "max_abs_err": max_err,
        **timings[HEADLINE],
    }, {
        "name": "lk_level_pass",
        "route": "cuda",
        "source": "stereo_vo_tpu_torch/csrc/lk_level.cu",
        "replaces": "stereo_vo_tpu/ops/pallas_extract.py:168 with stereo_vo_tpu/ops/lk.py:182",
        "launches": total("lk_level_pass"),
        **lk_record,
        "library_ms": None,
    }, {
        "name": "stereo_bm_at",
        "route": "cuda",
        "source": "stereo_vo_tpu_torch/csrc/stereo_bm_at.cu",
        "replaces": "stereo_vo_tpu/ops/pallas_extract.py:168 with stereo_vo_tpu/ops/stereo_bm.py:176",
        "launches": total("stereo_bm_at"),
        **bm_record,
        "library_ms": None,
    }, {
        "name": "greedy_nms",
        "route": "cuda",
        "source": "stereo_vo_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "stereo_vo_tpu/ops/shi_tomasi.py:221 (XLA while_loop) and :223-235 (cap, pack)",
        "launches": total("greedy_nms"),
        **nms_record,
        "library_ms": None,
    }] + [{
        "name": kernel,
        "route": "cuda",
        "source": "stereo_vo_tpu_torch/csrc/ba_lm.cu",
        "replaces": replaces,
        "launches": total(kernel),
        **ba_records[kernel],
    } for kernel, replaces in (
        ("ba_build", "stereo_vo_tpu/backend/schur.py:438 _build_system (XLA fusions, no Pallas)"),
        ("ba_damp_reduce", "stereo_vo_tpu/backend/schur.py:519 _damp_reduce (XLA fusions)"),
        ("ba_step", "stereo_vo_tpu/backend/schur.py:596 back-substitution, :383 cost, :661 "
                    "body update (XLA fusions)"),
        ("ba_cost", "stereo_vo_tpu/backend/schur.py:383 _lm_major_cost (XLA fusions)"),
    )] + [{
        "name": "pnp_hypotheses",
        "route": "cuda",
        "source": "stereo_vo_tpu_torch/csrc/pnp_hyp.cu",
        "replaces": "stereo_vo_tpu/frontend/pnp.py:346 one_hypothesis less the draw (XLA "
                    "fusions, no Pallas)",
        "launches": total("pnp_hypotheses"),
        **pnp_record,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
