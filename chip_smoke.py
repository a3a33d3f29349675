#!/usr/bin/env python3
"""Drive the PyTorch / H100 port of VFM registration on one card.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; takes no arguments. It builds the port's five
CUDA kernels from `vfmreg_tpu_torch/csrc/`, holds each against its plain
PyTorch version at the shapes each path gives it (B3 also against
`build_nn_cache`, B4 with a NaN query and an empty neighbourhood added, both
bit for bit; B1 also at its contract's edges: exact duplicate rows across
lanes, warps, tiles and splits, an all-masked database, N, M and D off the
tile sizes, each index equal to the plain version's; B2 and B3 lane-batched
at the driver's and the slice's 8 lanes, B2's finishing stage fed
the kernel's own moments against the plain one on the card, and their
one-lane entries), and drives fourteen paths. The first six run B1-B3, the
odometry B2 and B3, the descriptor passes, featup and train B5:

* slice: B = 8 scans of 16,384 points registered against a 524,288-point map
  with 384-d descriptors (bench.py's primary workload, 1000-iteration
  budget, random data from a seed) through `vfmreg_tpu_torch.scan_to_map`
  (VFM-ICP as lanes of one loop), every lane checked against its true
  pose, phase 1's reads of the device at most ceil(max phase-1 iterations
  / VFM_STEPS_PER_READ) + 1, and the batch bit for bit equal to 8
  one-lane `register_frame_vfm` calls on the same grid and correspondences;
* driver: the evaluation driver's method row on bench.py's driver scene at
  the same widths (B = 8 scans of 16,384 points, 524,288-point 384-d map,
  seed 0) through `vfmreg_tpu_torch.pipeline.registration_node
  .precompute_scene_batched`: GT ICP and the vfm RANSAC + refine ICP rows
  checked against the true poses on every lane, the vanilla ICP row
  reported, and a second call bit-identical to the first; then its two rare
  paths, each gated the same way: the 1 m retry (one scan cropped to an
  8 m radius) and the query-budget re-match (a budget of 4 queries);
* node: the evaluation driver's scene loop on the driver scene in a scene
  file's layout (`pipeline.synthetic.scene_file_layout`: the map as two map
  clouds, every descriptor row with a positive sum) through
  `RegistrationNode.run_scene` with the vfm RANSAC and TEASER columns, once
  batched (the card's default) and once serial: host map accumulation
  (one point per occupied 0.25 m voxel), the batched row or the serial
  methods, the serial TEASER column (B1 per correspondence search, exact max
  clique on the host, GNC-TLS on the card, one-lane ICP refine), errors
  and the recall summary (with the GNC steps per TEASER solve and per
  scene). GT ICP gated against the true poses, vfm RANSAC +
  ICP and vfm TEASER + ICP against GT ICP in the node's own tables, serial
  = batched (GT and vanilla ICP bit for bit, RANSAC within 2e-3), B1-B3
  checked at the serial column's shapes, and `register_frame`'s VFM branch
  on one full-width scan gated against its true pose;
* node_baselines: the paper's baseline methods in the same scene loop. The
  reference torch modules' golden state dicts (`tests/golden/{dip,gedi,
  spinnet,pointdsc}_reference_golden.npz`) written to .pt files named by
  `VFMREG_{DIP,GEDI,SPINNET,POINTDSC}_WEIGHTS`, so the models load as a
  user's do, at full width; each reproduces its golden activations on the
  card (tests/test_reference_goldens.py's tolerances); FCGF's and GCL's
  seeded weights written the same way (their goldens stay off the card
  machine); FPFH + mutual NN + RANSAC recovers the structured corner's
  transform within 0.7 m (tests/test_fpfh.py's case);
  `RegistrationNode.run_scene` on the node's scene with the reference's
  full default matrix (RANSAC + ICP over fpfh, dip, gedi, fcgf, gcl,
  spinnet, vfm; TEASER + ICP over fpfh, vfm; PointDSC + ICP over fpfh,
  fcgf) and `dump_viz_dir` set, every pose finite and rigid, every error
  key of the reference's make_step, GT and vfm rows gated as in node, B2
  and B3 launched as the loops count, seconds per method and stage, every
  visualization file parsed against its header; then the card against the
  port's CPU evaluation on the first scan (extractor points equal, FPFH
  rows, DIP / GeDi / SpinNet / FCGF / GCL cosines, mutual NN pairs in both
  modes apart from ties, the FPFH TEASER and PointDSC poses), one level of
  the sparse convolution at full width on the map against the CPU, and B2
  and B3 at the fpfh RANSAC refine's start;
* node_experiments: the same scene loop on the node's scene (2 scans) in
  the reference's experiment modes, each serial, with the vfm RANSAC and
  TEASER columns: cluster removal at p = 0.5 on the map with 6 planted
  trees (descriptor columns 0-2 the reference's tree colours, the
  generator's PCA fit set on them; host PCA colours, region growth on the
  native KD-tree, HDBSCAN), insertion of 5 tree clusters from .npy files,
  scan-to-scan on the scene's nearest map cloud and on 12 SyntheticDrive
  sweeps written as KITTI .bin frames: HDBSCAN finds every tree, each
  removal takes some and leaves some, `points_in_map` equals a rerun of
  the same host helpers, every GT-ICP lane within the recall gate (the
  KITTI pair's against the drive's motion), every pose finite and rigid,
  B1-B3 launched as the searches and loops count in each mode, seconds per
  mode with the host clustering apart, and B1-B3 at the removal's shapes;
* node_sharded: the driver row's multi-device modes at world size 1 through
  NCCL (one rank over a FileStore in a temporary directory; the card
  machine has one card, so the modes' scaling over cards is not measured
  here): the single-device row in turns without and with
  VFMREG_PROFILE_DRIVER (the per-stage barriers' cost; equal results) and
  once with VFMREG_PROFILE_ICP_ITERS, then `precompute_scene_batched(mesh=)`
  scan-sharded and map-sharded on the driver scene: every pose and count
  equal bit for bit to the single-device row's (the map-sharded vanilla
  row, one full-budget loop as the reference runs it, to the row under
  VFMREG_PROFILE_ICP_ITERS), the recall gate, B1-B3 launched as the loops
  count, the collective calls counted and timed by CUDA events;
  `RegistrationNode(map_sharding=True)` on the node scene at 2 scans equal
  to the default node; and B2 at the merged widths K = 64 and 128 (the
  driver map's stored rows split in 2 and 4 contiguous blocks, a grid and
  B3 per block, the planes concatenated): against its plain version, and
  one GN step at refresh_interval=1 equal bit for bit to the one grid's;
* odometry: KISS odometry (`kiss.kiss_icp.KissICP`, the default config:
  100 m range, 1 m voxels, 20 points a voxel, the map resident on the card)
  over a 200-frame drive of `pipeline.synthetic.SyntheticDrive` (122,880
  points a frame, a KITTI HDL-64E sweep, 2 cm range noise; 1 m a frame,
  up to 2 deg of yaw; ground, facades, poles and boxes; seed 0): every
  frame's pose against the truth, the resident map against the same poses
  replayed into a host-side map (the same rows in the same order every 50
  frames), B2 and B3 checked at the last frame's shapes, per-stage seconds
  per frame (a synchronize after each stage), then fresh free-running runs
  of the first 40 frames (one synchronize at the end; with the map's
  lagged point count and with a synchronize after every update, in turns)
  and the idle share of such a run; then odometry_readers, the drive's
  first 20 frames written as a MulRan and as a Boreas sequence and run by
  `kiss.pipeline.OdometryPipeline` through `kiss.datasets.dataset_factory`
  with the default config: every frame read back as written, each
  reader's ground truth as written after its documented transform, every
  pose gated, the two runs' poses bit for bit equal, B2 and B3 launched as
  the loops count; then odometry_xd, the first 20 frames with 384-d
  descriptor columns through the XD path (cosine-weighted champions, plain
  PyTorch on the card, no kernel launch), every pose gated;
* descriptor: the DINOv2 descriptor pass at ViT-S/14 full width (384
  wide, 12 layers, 6 heads of 64) with random weights from a seeded
  generator (no checkpoint is in the repository), over 8 clouds of 16,384
  points and the five-camera synthetic rig (40 images of 1232 x 1616 ->
  224 x 280, T = 321 tokens) through
  `vfmreg_tpu_torch.pipeline.prepare_scenes.create_descriptors`: kernel B5
  once per ViT block, the points with a descriptor exactly those the rig's
  own projection covers, and every descriptor within cosine 0.9999 of a
  second run with the plain attention;
* descriptor_maskclip: the same pass with MaskCLIP (`models/maskclip.py`)
  at CLIP ViT-B/16 full width (768 wide, 12 layers of 12 heads of 64, the
  last block value-only, 512-d out; random seeded weights), the images
  resized to 256 x 320 (T = 321): B5 once per softmax block, 11 a image,
  512-d descriptors on exactly the points the rig's projection covers, and
  the first cloud's within cosine 0.9999 of the port's CPU evaluation of
  the same generator (B5's plain version);
* featup: `get_image_features(upsample=True)` with `use_featup=True` on the
  first cloud's five images at ViT-S/14 -> [1232, 1616, 384], once with
  seeded parameters of FeatUp's learned JBU stack and once without (the
  classical JBU at the image's resolution), seconds per image, B5 12 a
  image, and the stack's [256, 320, 384] output for the first image within
  FEATUP_ATOL of the port's CPU evaluation;
* clip_text: CLIP's text tower at full width (512 wide, 12 layers, 8
  heads, context 77; random seeded weights) on the MaskCLIP generator:
  five prompts encoded and held within TEXT_ATOL of the CPU evaluation,
  and `compute_similarity` of the first cloud's MaskCLIP descriptors
  against one, finite, within [-1, 1] and 0 on zero rows;
* train: the trainer (`train.trainer`) fine-tuning ViT-S/14 at full width
  (plain attention, random seeded weights) and its adapter 384 -> 512 ->
  128 with the default TrainConfig (AdamW, lr 1e-4, decay 0.05, T 0.07),
  dp x tp on a (1, 1) ("data", "model") mesh through NCCL (one rank over a
  FileStore, so every collective of the split step runs): 8 pairs of
  224 x 280 views (T = 321; view b = view a + noise), 256 corresponding
  patches a pair ([2,048 x 2,048] logits), seed 0. Step 1 against the
  port's CPU step (loss, accuracy, every gradient leaf) and against the
  same step with `mesh=None` (bit for bit); 20 timed steps (steps/s,
  images/s, median / p90, peak memory), the loss finite and descending;
  a checkpoint after step 10 restored into a fresh state, its next step
  bit for bit; 5 steps with the stage clock and their collectives; a step
  with `use_flash_attention=True` refused with B5's "no backward" error
  (no B5 launch in any step); then B5 at the trainer's [16, 321, 6, 64]
  (block 0 of the trained ViT) and the trained ViT's forward under
  `no_grad` with B5, its patch descriptors within cosine 0.9999 of plain
  attention's.

Each path runs with the launch counts set to 0 just before it and read just
after, and fails unless every kernel of the path was launched as often as
the path's own counts say: B1 at least once (in the node, once per serial
correspondence search besides), B2 once per step call of the ICP loops
(each call steps every live lane of a row; in the node and the odometry,
summed over every ICP loop the path ran, `registration.icp.recording_loops`),
B3 once per rebuild round, B5 12 times per image (11 with MaskCLIP; 12
per forward of the train path's batch of 16, none in its steps);
odometry_xd launches none. Per ICP row it prints the loop's step calls,
reads and rebuild rounds beside the lanes' iterations and rebuilds, and
checks them against each other (`loop_check`). No path launches B4 (the ICP
takes the fused B2); it is checked at the slice's, the driver's and the
odometry's champion caches, at the slice cache cut to a ragged 16,381
columns and at the driver cache's first 7 rows, each with its event,
CUDA-graph and cold-L2 times.

B1 and B5 run 3xTF32 on the tensor cores, so their bound is three TF32
products per f32 product at the TF32 tensor-core rate; B2-B4 keep the f32
CUDA-core rate. It prints one JSON line per phase (device, build, data,
warmup, kernel_check for each kernel on the slice, slice, driver_data,
kernel_check for each kernel on the driver row, driver, driver_retry,
driver_rematch, node_data, node_batched, node_serial,
node_serial_vs_batched, kernel_check for B1-B3 at the node's serial shapes,
node_register_frame_vfm, node_baselines_golden, node_baselines_fpfh_corner,
node_baselines, node_baselines_vs_cpu, node_baselines_sparse_conv,
kernel_check for B2 and B3 at the
fpfh refine's start, node_experiments_data, node_experiments_removal,
node_experiments_insertion, node_experiments_scan_to_scan_data,
node_experiments_scan_to_scan_kitti, kernel_check for B1-B3 at the
removal's shapes, node_sharded_scan_sharded, node_sharded_map_sharded,
node_sharded_node, kernel_check for B2 at K = 64 and 128,
node_sharded_merged_caches, node_sharded, odometry_data, odometry, kernel_check for B2 and
B3 at the odometry's shapes, kernel_check for B4 at the odometry's cache,
odometry_free, odometry_idle, odometry_readers_data, odometry_readers for
each reader, odometry_readers_equal, odometry_xd, kernel_check for B5
at the pass's own q, k, v, at
[2, 200, 4, 32] and at T = 320, descriptor, descriptor_vitg14_data,
kernel_check for B5 at the ViT-g/14-reg pass's [1, 325, 24, 64],
descriptor_vitg14, kernel_check for B5 at the
MaskCLIP pass's q, k, v [1, 321, 12, 64], descriptor_maskclip, featup,
clip_text, kernel_check for B5 at the trainer's [16, 321, 6, 64], train,
script: the whole run's seconds), then
the `kernels` line (per kernel the newest path's numbers, and each path's
under "paths"), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Any failed check raises and the script
exits nonzero; without CUDA, or without the port package beside it, it
exits nonzero before printing any result.
"""

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:326-327, the reference's production shapes; bench.py:352 runs the
# driver scene at the same widths.
BATCH, N_MAP, N_SCAN, DIM, N_VFM, MAX_ITERATIONS = 8, 524288, 16384, 384, 512, 1000
SEED = 0
DEVICE = "cuda"
# Recall gate of every lane (.claude/skills/verify/SKILL.md's drive recipe).
RTE_GATE_M, RRE_GATE_DEG = 0.3, 1.5
# Kernel tolerances. B1: similarities within SIM_ATOL; indices equal wherever
# the top-2 similarity gap exceeds GAP (below it, the f32 summation order may
# pick either row). B2: each moment within MOMENT_RTOL of the sum of the
# absolute values of its terms (the kernel sums in another order).
SIM_ATOL, GAP, MOMENT_RTOL = 1e-5, 1e-5, 1e-4
# Node phase: the RANSAC rows of the serial and batched runs within this of
# each other (tests/test_harness.py's bar); GT and vanilla ICP bit for bit.
SERIAL_RANSAC_ATOL = 2e-3
# The driver's retry call crops this scan to an 8 m radius.
RETRY_SCAN = 1
# B2's finishing stage fed the kernel's own moments is held bit for bit
# against the plain version on the card (the same f32 operations in the same
# order, sinf and cosf the same functions): dx, est, T and the lane state.
# The moved source: bit for bit against the plain move in the kernel's order
# of operations, and within GN_SRC_ULPS units in the last place of the
# point's largest coordinate of `transform_points`, whose product fuses a
# multiply and an add twice per coordinate where the kernel rounds each
# (1 ulp measured at the slice, H100 80GB HBM3, 700 W).
GN_SRC_ULPS = 2
# B5: max abs error against the einsum softmax (tests/test_vit.py's bar).
# Descriptor pass: cosine of every covered point's descriptor against the
# run with plain attention.
ATTN_ATOL, DESC_COS = 2e-5, 0.9999
# Descriptor pass: ViT-S/14 (vit.py PRESETS["dinov2_vits14"]), 12 blocks.
VIT_PRESET, VIT_LAYERS = "dinov2_vits14", 12
# descriptor_vitg14 phase: DINOv2 ViT-g/14 with registers at its published
# widths and depth (40 blocks, 24 heads of 64, T = 1 + 4 + 16 x 20 = 325 at
# the rig's 224 x 280), its 1.1 B random weights drawn on the card; the
# cosine gate against plain attention on the first cloud's five images.
VITG_PRESET, VITG_LAYERS, VITG_TOKENS = "dinov2_vitg14_reg", 40, 325
# FeatUp phase: the learned stack's [16h, 16w, 384] output on the card
# against the port's CPU evaluation of the same function, max abs error (f32
# matmuls, softmaxes and sums in other orders over features of unit scale).
# Text phase: the text tower's embeddings against its CPU evaluation, max
# abs error; cosine similarities may pass 1 by rounding, by at most
# SIM_RANGE_SLACK.
FEATUP_ATOL, TEXT_ATOL, SIM_RANGE_SLACK = 1e-4, 1e-4, 1e-6
# Odometry phase: a drive of ODO_FRAMES KITTI-sized sweeps (122,880 points,
# an HDL-64E sweep); the resident map checked against a host-side replay
# every ODO_CHECK_EVERY frames; the idle share over a fresh run of the first
# ODO_IDLE_FRAMES; the descriptor (XD) run over the first ODO_XD_FRAMES.
ODO_FRAMES, ODO_POINTS, ODO_CHECK_EVERY, ODO_IDLE_FRAMES, ODO_XD_FRAMES = 200, 122880, 50, 40, 20
# odometry_readers phase: the drive's first ODO_READER_FRAMES frames on disk
# as MulRan and as Boreas. Each reader's ground truth against the written
# poses after its transform: within READER_GT_ATOL in float64 (MulRan: two
# 4 x 4 products and two inverses of poses within 20 m), within
# READER_GT_F32_ATOL where the reader stores f32 (Boreas: half an ulp of f32
# at 20 m is 9.5e-7, plus the Euler angles' round trip).
ODO_READER_FRAMES, READER_GT_ATOL, READER_GT_F32_ATOL = 20, 1e-9, 1e-5
# Odometry pose gate, every frame's pose against the truth: about twice what
# the 200-frame drive reads with its 2 cm range noise (max RTE 0.052 m, RRE
# 0.031 deg; H100 80GB HBM3, 700 W), well inside the recall gate above.
ODO_RTE_GATE_M, ODO_RRE_GATE_DEG = 0.1, 0.1
# node_baselines phase. Goldens on the card: the reference torch modules'
# activations at tests/test_reference_goldens.py's tolerances. The FPFH
# corner at tests/test_fpfh.py's 0.7 m. Rigid poses: |R^T R - I| below
# RIGID_ATOL. The scene loop over NODE_BASELINE_SCANS scans of the node
# phase's scene: the map's extractions take 92 s and SpinNet's 7,500
# keypoints 23 s a scan (H100 80GB HBM3, 700 W), so two scans, the fewest
# the batched row takes, keep the phase near its target. The card against
# the CPU on the first scan: FPFH rows within cosine FPFH_ROW_COS on
# FPFH_ROW_SHARE of them and a median cosine of FPFH_MEDIAN_COS (the normals
# agree bit for bit, but the card's atan2 differs by an ulp and a pair near a
# bin edge moves one bin, in its own row and, weighted, in each neighbour's;
# a row with few pairs then turns; 99.2 % of the rows read above 0.99 on an
# H100 80GB HBM3 at 700 W); DIP on its points
# within CROP_M of the sensor, GeDi on GEDI_POINTS of those within
# GEDI_CROP_M, SpinNet at SPIN_KEYPOINTS keypoints, each within DESC_COS;
# mutual NN against the map's descriptors within MAP_CROP_M of the scan, ties
# within MNN_TIE_RTOL of the mean squared descriptor norm; the FPFH TEASER
# and PointDSC poses from those pairs, and PointDSC's on a known motion
# (scan 0's points, 30 % outliers), within BASELINE_POSE_M /
# BASELINE_POSE_DEG; PointDSC's encoder on the FPFH pairs within PDSC_ATOL.
GOLDEN_ATOL = {"dip": 1e-4, "gedi_quat": 1e-5, "gedi": 1e-4, "spinnet_trunk": 2e-4, "spinnet_var_to_invar": 1e-5,
               "pointdsc_encoder": 2e-4, "pointdsc_confidence": 2e-4, "pointdsc_final_trans": 2e-4}
CORNER_GATE_M, RIGID_ATOL = 0.7, 1e-5
NODE_BASELINE_SCANS = 2
FPFH_ROW_COS, FPFH_ROW_SHARE, FPFH_MEDIAN_COS = 0.99, 0.99, 0.999999
CROP_M, GEDI_CROP_M, GEDI_POINTS, SPIN_KEYPOINTS, MAP_CROP_M = 10.0, 6.0, 500, 64, 35.0
MNN_TIE_RTOL, PDSC_ATOL = 1e-5, 1e-3
BASELINE_POSE_M, BASELINE_POSE_DEG = 1e-3, 1e-2
# FCGF and GCL (seeded weights written to .pt files named by
# VFMREG_{FCGF,GCL}_WEIGHTS): on the first scan each descriptor row within
# cosine DESC_COS of the port's CPU evaluation and every entry within
# RESUNET_ATOL, the points equal. An H100 80GB HBM3 at 700 W read a max abs
# error of 2.1e-7 (FCGF) and 2.4e-7 (GCL) and cosines of 1 - 7.5e-14; the
# atol is what catches TF32 matmuls (~1e-3 on these unit-norm rows), which
# the cosine does not. One level of
# `sparse_conv_apply_map` at GCL's widest level-0 width (block2_tr.conv1,
# 128 -> 128 over 27 offsets) on the map's 0.3 m voxels against the CPU:
# the kernel map equal, the outputs within SPARSE_CONV_ATOL (f32 sums of
# 3,456 products of unit-scale terms in another order: ~5e-6 typical).
SPARSE_CONV_ATOL, RESUNET_ATOL = 1e-4, 1e-5
# node_experiments phase: the node's scene cut to EXP_SCANS scans, with
# EXP_TREES vertical clusters of EXP_TREE_POINTS points planted in the map
# (a trunk of r 0.3 m to 3 m under a crown of r 2 m at 5 m), each whose
# descriptor columns 0-2 are one of the reference's tree colours over 255;
# every other row's columns 0-2 lie more than 86 colour units from both
# (column 1 >= 0.75), and two anchor rows at 0 and 1 fix the min-max
# normalisation of the generator's PCA fit, the projection onto columns 0-2.
# Removal at EXP_REMOVAL_P; insertion at EXP_INSERT_P of EXP_INSERT_FILES
# such clusters as .npy files; scan-to-scan on the data and on
# EXP_KITTI_FRAMES SyntheticDrive sweeps as KITTI .bin files (the reference
# draws the first frame among all but the last 10).
EXP_SCANS, EXP_TREES, EXP_TREE_POINTS, EXP_REMOVAL_P, EXP_INSERT_P = 2, 6, 3000, 0.5, 0.05
EXP_INSERT_FILES, EXP_KITTI_FRAMES = 5, 12
EXP_TREE_COLORS = ((217, 60, 165), (118, 105, 57))
# node_sharded phase: the node at NODE_SHARDED_SCANS scans with and without
# map_sharding; B2 at the merged widths of MERGED_WORLDS ranks (K = 32 x world).
NODE_SHARDED_SCANS, MERGED_WORLDS = 2, (2, 4)
# train phase: the trainer (`train/trainer.py`) at ViT-S/14 full width with
# plain attention and the default TrainConfig, on a ("data", "model") mesh of
# (1, 1) over NCCL: TRAIN_PAIRS pairs of TRAIN_HW views (the descriptor
# pass's ViT input: T = 321), view b = view a + 0.05 noise (as
# tests/test_trainer.py), TRAIN_K corresponding patches a pair, seed 0. One
# warm-up step (step 1), TRAIN_STEPS timed steps, a checkpoint after step
# TRAIN_CKPT_STEP, TRAIN_CLOCK_STEPS more with the stage clock. Step 1 on the card
# against the port's CPU step from the same parameters on the same batch:
# the loss within a relative TRAIN_LOSS_RTOL, the accuracy within
# TRAIN_ACC_ATOL (two of the 2,048 rows' argmax at a near-tie), each
# gradient leaf within TRAIN_GRAD_RTOL of its own largest entry; the k
# biases, whose exact gradient is zero (the softmax ignores a constant added
# to every key), below TRAIN_ZERO_GRAD_RTOL of the largest gradient entry on
# both sides (tests/test_torch_trainer.py's rules, at 12 layers).
TRAIN_PAIRS, TRAIN_HW, TRAIN_K, TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_CLOCK_STEPS = 8, (224, 280), 256, 20, 10, 5
TRAIN_LOSS_RTOL, TRAIN_ACC_ATOL = 1e-5, 2 / (8 * 256)
TRAIN_GRAD_RTOL, TRAIN_ZERO_GRAD_RTOL = 1e-4, 1e-6
# B4 is checked at each path's champion cache and at two shapes its design
# handles apart: the slice cache's first NN_RAGGED_N columns (n not a
# multiple of 4, so no row starts 16-byte aligned and every tile is read by
# plain loads) and the driver cache's first NN_SMALL_K rows (the generic
# runtime-K form). Its cold time is the median of NN_COLD_LAUNCHES single
# launches, each after FLUSH_BYTES are read (over twice the H100's 50 MB
# L2) and a spin of SPIN_CYCLES clock cycles covers the host's enqueue.
NN_RAGGED_N, NN_SMALL_K, NN_COLD_LAUNCHES, FLUSH_BYTES, SPIN_CYCLES = 16381, 7, 50, 128 << 20, 1_000_000
# Published peaks of an H100 (NVIDIA data sheet, dense, SXM at 700 W): HBM
# rate, f32 CUDA-core rate and TF32 tensor-core rate. The PCIe card is
# slower. B1 and B5 run 3xTF32 on the tensor cores (three TF32 products per
# f32 product), so their operation bound is 3 x flops at the TF32 rate.
PEAKS = {"SXM": (3.35e12, 67e12, 495e12), "PCIe": (2.0e12, 51e12, 378e12)}
# The numbers of a kernel row that are kept for each path that runs it.
PATH_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def emit(obj):
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def env_switch(name):
    """The driver's profiling switch `name` (VFMREG_PROFILE_DRIVER or
    VFMREG_PROFILE_ICP_ITERS) set to 1 for the block."""
    kept = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if kept is None:
            del os.environ[name]
        else:
            os.environ[name] = kept


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps, warmup=1):
    """Mean milliseconds per call on the card (CUDA events after a warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, launches=100):
    """Mean device milliseconds per call with the host's launch cost taken
    out: `launches` calls captured in one CUDA graph, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_time_ms(graph.replay, reps=10, warmup=2) / launches


def top2_gap(q, db, mask, chunk=8192):
    """Best minus second-best masked similarity per query (plain, chunked)."""
    import torch

    top = torch.full((q.shape[0], 2), -float("inf"), device=q.device)
    for off in range(0, db.shape[0], chunk):
        sim = q @ db[off : off + chunk].T
        sim = torch.where(mask[None, off : off + chunk], sim, -float("inf"))
        top = torch.topk(torch.cat([top, sim], dim=1), 2, dim=1).values
    return top[:, 0] - top[:, 1]


def _bound(nbytes, flops, peaks):
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def _bound_3xtf32(nbytes, flops, peaks):
    """The bound of a kernel that runs its `flops` as three TF32 products
    each on the tensor cores."""
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, 3 * flops / peaks[2] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations (3xTF32)"}


def cosine_probes(dev):
    """Kernel B1 at the contract's edges, against its plain version and the
    index the contract names, on 131 queries (128 + 3) against 1,000 rows
    (7 tiles of 128 + 104): groups of exact duplicate rows placed in one
    thread's column pair, in neighbouring lanes, fragments and warps of one
    tile, and in later tiles (each tile is its own split here), where the
    lowest unmasked index must win; an all-masked database, which must give
    (-1e30, 0); and D = 30, which takes the kernel's 4-byte copies."""
    import torch

    from vfmreg_tpu_torch.ops.cosine_kernel import cosine_argmax, cosine_argmax_plain

    g = torch.Generator(device="cpu").manual_seed(SEED)

    def unit(*shape):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        return (x / x.norm(dim=-1, keepdim=True)).float().to(dev)

    n, m = 131, 1000
    db, q = unit(m, DIM), unit(n, DIM)
    mask = torch.ones(m, dtype=torch.bool, device=dev)
    groups = [[8, 9, 10, 16, 40, 136, 999], [391, 300, 263, 262], [500, 501, 620]]
    mask[500] = False  # the group's lowest row is masked: 501 must win
    expect = torch.zeros(n, dtype=torch.int32, device=dev)
    tied = torch.zeros(n, dtype=torch.bool, device=dev)
    for gi, rows in enumerate(groups):
        db[rows] = db[rows[0]].clone()
        for j in range(3):  # three queries per group, at both ends of the batch
            qi = 3 * gi + j if j < 2 else n - 1 - gi
            q[qi] = db[rows[0]]
            expect[qi] = min(r for r in rows if bool(mask[r]))
            tied[qi] = True
    out = {}

    def compare(name, q, db, mask, want_idx=None, want_sim=None):
        sim_k, idx_k = cosine_argmax(q, db, mask)
        sim_p, idx_p = cosine_argmax_plain(q, db, mask)
        decisive = top2_gap(q, db, mask) > GAP  # none where every row is masked
        err = float((sim_k - sim_p).abs().max())
        ok = err <= SIM_ATOL and torch.equal(idx_k[decisive], idx_p[decisive])
        if want_idx is not None:
            sel = want_idx[1]
            ok = ok and torch.equal(idx_k[sel], want_idx[0][sel]) and torch.equal(idx_k[sel], idx_p[sel])
        if want_sim is not None:
            ok = ok and torch.equal(sim_k, want_sim) and torch.equal(sim_k, sim_p) and torch.equal(idx_k, idx_p)
        out[name] = {"ok": bool(ok), "max_abs_err": err, "decisive": int(decisive.sum()), "queries": q.shape[0]}

    compare("duplicates", q, db, mask, want_idx=(expect, tied))
    compare("all_masked", q, db, torch.zeros_like(mask),
            want_idx=(torch.zeros_like(expect), torch.ones_like(tied)),
            want_sim=torch.full((n,), -1e30, device=dev))
    compare("d30", unit(n, 30), unit(m, 30), mask)
    return out


def check_cosine(path, qn, dbn, valid, live, peaks):
    """Kernel B1 on the queries [N, D] that `path` hands it, with the live
    mask [N] it passes (the rest of the rows are the batch's padding): the
    masked call against the dense call (every row computed) bit for bit on
    the live rows and (-1e30, 0) on the others, against its plain version
    (most live rows must have a decisive best match), and `row_stats`' live
    rows; then at the contract's edges (`cosine_probes`). Times the masked
    call (bound: the live rows' work), the dense call and the plain
    version."""
    import torch

    from vfmreg_tpu_torch.ops.cosine_kernel import cosine_argmax, cosine_argmax_plain, reset_row_stats, row_stats

    t0 = time.perf_counter()
    probes = cosine_probes(qn.device)
    reset_row_stats()
    sim_k, idx_k = cosine_argmax(qn, dbn, valid, live)
    stats = row_stats()
    sim_d, idx_d = cosine_argmax(qn, dbn, valid)
    sim_p, idx_p = cosine_argmax_plain(qn, dbn, valid, live)
    decisive = top2_gap(qn, dbn, valid) > GAP
    torch.cuda.synchronize()
    n_live = int(live.sum())
    live_equal = bool(torch.equal(sim_k[live], sim_d[live]) and torch.equal(idx_k[live], idx_d[live]))
    fill_ok = bool((sim_k[~live] == -1e30).all() and (idx_k[~live] == 0).all())
    err = float((sim_k - sim_p).abs().max())
    idx_bad = int(((idx_k != idx_p) & decisive).sum())
    ok = (live_equal and fill_ok and stats == {"rows_passed": qn.shape[0], "live_rows": n_live}
          and err <= SIM_ATOL and idx_bad == 0 and bool(decisive[live].float().mean() > 0.5)
          and all(p["ok"] for p in probes.values()))

    def library():
        sim = torch.mm(qn, dbn.T)
        sim.masked_fill_(~valid[None, :], -1e30)
        return sim.max(dim=1)

    ms = cuda_time_ms(lambda: cosine_argmax(qn, dbn, valid, live), reps=5)
    dense_ms = cuda_time_ms(lambda: cosine_argmax(qn, dbn, valid), reps=5)
    plain_ms = cuda_time_ms(lambda: cosine_argmax_plain(qn, dbn, valid, live), reps=3)
    library_ms = cuda_time_ms(library, reps=3)
    n, d = qn.shape
    m_valid = int(valid.sum())
    flops = 2.0 * n_live * m_valid * d
    nbytes = 4.0 * (n_live * d + m_valid * d) + dbn.shape[0] + 8.0 * n_live
    row = {
        "name": "cosine_argmax", "route": "cuda", "ok": ok, "source": "vfmreg_tpu_torch/csrc/cosine_argmax.cu",
        "replaces": "vfmreg_tpu/ops/cosine_kernel.py:56",
        "max_abs_err": err, "ms": ms, "dense_ms": dense_ms, "plain_ms": plain_ms,
        **_bound_3xtf32(nbytes, flops, peaks), "library_ms": library_ms,
    }
    row["shape"] = [n, dbn.shape[0], d]
    emit({"phase": "kernel_check", "path": path, "kernel": "cosine_argmax",
          "m_valid": m_valid, "live_queries": n_live, "live_equal_dense": live_equal, "fill_ok": fill_ok,
          "row_stats": stats, "idx_disagree_decisive": idx_bad,
          "idx_disagree_within_gap": int(((idx_k != idx_p) & ~decisive).sum()),
          "decisive_live_queries": int(decisive[live].sum()), "tflops": flops / ms / 1e9,
          "probes": probes, "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"cosine_argmax: live_equal_dense={live_equal} fill_ok={fill_ok} row_stats={stats} "
                           f"err={err} idx_bad={idx_bad} probes={probes}")
    return row


def check_gn(path, cache, source, center, kernel, max_dist, peaks):
    """Kernel B2 against its plain version on one champion cache of `path`,
    with that path's Geman-McClure kernel and distance gate."""
    import torch

    from vfmreg_tpu_torch.ops.gn_kernel import gn_moments_from_cache, gn_terms_plain

    t0 = time.perf_counter()
    args = (cache.cx, cache.cy, cache.cz, source, center, kernel, max_dist)
    m_k = gn_moments_from_cache(*args)
    terms = gn_terms_plain(*args)
    m_p, scale = terms.sum(dim=1), terms.abs().sum(dim=1)
    torch.cuda.synchronize()
    diff = (m_k - m_p).abs()
    err = float(diff.max())
    ok = bool(torch.all(diff <= MOMENT_RTOL * scale)) and float(m_p[0]) > 0
    ms = cuda_time_ms(lambda: gn_moments_from_cache(*args), reps=200, warmup=10)
    plain_ms = cuda_time_ms(lambda: gn_terms_plain(*args).sum(dim=1), reps=20)
    k, n = cache.cx.shape
    nbytes = 4.0 * (3 * k * n + 3 * n + 17)
    flops = float(n) * (8 * k + 60)
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    row = {
        "name": "gn_moments_from_cache", "route": "cuda", "ok": ok, "source": "vfmreg_tpu_torch/csrc/gn_moments.cu",
        "replaces": "vfmreg_tpu/ops/gn_kernel.py:98",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }
    row["shape"] = [k, n]
    emit({"phase": "kernel_check", "path": path, "kernel": "gn_moments_from_cache", "entry": "one_lane",
          "kernel_width": kernel, "max_dist": max_dist,
          "max_rel_err_of_scale": float((diff / scale.clamp(min=1e-30)).max()),
          "accepted": float(m_p[0]), "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"gn_moments_from_cache disagrees with its plain version: {diff.tolist()}")
    return row


def check_champions(path, planes, src, mask, group, ref_cache, peaks):
    """Kernel B3 against its plain version and against `build_nn_cache`'s
    planes on one slab gather: all three must be equal bit for bit."""
    import torch

    from vfmreg_tpu_torch.ops.champion_kernel import champions_from_planes, champions_from_planes_plain

    t0 = time.perf_counter()
    args = (*planes, src, mask, group)
    got = champions_from_planes(*args)
    plain = champions_from_planes_plain(*args)
    torch.cuda.synchronize()
    ref = (ref_cache.cx, ref_cache.cy, ref_cache.cz)
    equal_plain = all(torch.equal(a, b) for a, b in zip(got, plain))
    equal_cache = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    alive = int((got[0][:27] < 1e19).sum())
    ok = equal_plain and equal_cache and alive > 0
    ms = cuda_time_ms(lambda: champions_from_planes(*args), reps=200, warmup=10)
    plain_ms = cuda_time_ms(lambda: champions_from_planes_plain(*args), reps=20)
    kg, n = planes[0].shape
    nbytes = 4.0 * (3 * kg * n + 3 * n + 3 * 32 * n) + n
    flops = 8.0 * kg * n
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    row = {
        "name": "champions_from_planes", "route": "cuda", "ok": ok,
        "source": "vfmreg_tpu_torch/csrc/champions_from_planes.cu",
        "replaces": "vfmreg_tpu/ops/champion_kernel.py:81",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }
    row["shape"] = [kg, n]
    emit({"phase": "kernel_check", "path": path, "kernel": "champions_from_planes", "entry": "one_lane",
          "group": group, "equal_plain": equal_plain, "equal_build_nn_cache": equal_cache,
          "alive_champions": alive, "gbytes_per_s": nbytes / ms / 1e6,
          "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"champions_from_planes disagrees: plain {equal_plain}, "
                           f"build_nn_cache {equal_cache}, alive {alive}")
    return row


def loop_check(loop, iterations, rebuilds, steps_per_read, max_rounds):
    """The accounting of one ICP row's lane-batched loop (`ICPLanes.loop`,
    summed over the row's calls) against the lanes' own device counters:
    the lanes the host flagged for a rebuild are the device's rebuild counts;
    each round of `steps_per_read` step calls advances every unfinished
    lane, so the rounds are at most `max_rounds` (a row's longest lane, or
    the sum over one-lane calls); the loop
    reads the device once per round and once per call (the poses), which is
    at most ceil(step calls / steps per read) + rebuild rounds."""
    rounds = loop["step_calls"] // steps_per_read
    out = {
        "step_calls": loop["step_calls"], "reads": loop["reads"], "rebuild_rounds": loop["rebuild_rounds"],
        "gather_rounds": loop["gather_rounds"], "lane_rebuilds": loop["lane_rebuilds"],
        "lane_gathers": loop["lane_gathers"], "iterations": list(iterations), "rebuilds": list(rebuilds),
        "max_lane_iterations": max(iterations), "sum_lane_iterations": sum(iterations),
    }
    out["ok"] = (rounds * steps_per_read == loop["step_calls"]
                 and loop["lane_rebuilds"] == sum(rebuilds)
                 and rounds <= max_rounds
                 and loop["reads"] <= -(-loop["step_calls"] // steps_per_read) + loop["rebuild_rounds"])
    return out


def lane_planes(grid, src, mask, group):
    """Per-lane candidate planes [3, B, 27 * group, N] of one slab gather at
    the lanes' positions src [B, N, 3], and each lane's `build_nn_cache`."""
    import torch

    from vfmreg_tpu_torch.ops.hash_grid import build_nn_cache, gather_candidate_slabs

    planes, caches = [], []
    for j in range(src.shape[0]):
        cands = gather_candidate_slabs(grid, src[j], mask[j])
        planes.append(torch.stack(cands.planes(group)))
        caches.append(build_nn_cache(cands, src[j], mask[j]))
        del cands
    return torch.stack(planes, dim=1).contiguous(), caches


def check_champions_lanes(path, planes, src, mask, group, caches, peaks):
    """Lane-batched kernel B3 on every lane of `path`'s ICP row at once:
    bit for bit against its plain version and against each lane's
    `build_nn_cache`; an unflagged lane's planes untouched."""
    import torch

    from vfmreg_tpu_torch.ops import champion_kernel as ck
    from vfmreg_tpu_torch.ops.gn_kernel import KEEP, REBUILT

    t0 = time.perf_counter()
    b, kg, n = planes[0].shape
    dev = src.device
    flags = torch.full((b,), REBUILT, dtype=torch.int32, device=dev)
    args = (planes[0], planes[1], planes[2], src, mask, flags, group)
    got, plain = ck.new_champion_buffer(b, n, dev), ck.new_champion_buffer(b, n, dev)
    ck.champions_from_planes_lanes(*args, got)
    ck.champions_from_planes_lanes_plain(*args, plain)
    equal_plain = torch.equal(got, plain)
    equal_cache = all(torch.equal(got[c, j], ref) for j, cache in enumerate(caches)
                      for c, ref in enumerate((cache.cx, cache.cy, cache.cz)))
    # One lane not flagged: its planes stay as they were.
    keep = got.clone()
    keep[:, b // 2, :27] = 7.0
    before = keep[:, b // 2].clone()
    flags1 = flags.clone()
    flags1[b // 2] = KEEP
    ck.champions_from_planes_lanes(*args[:5], flags1, group, keep)
    untouched = torch.equal(keep[:, b // 2], before)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    alive = int((got[0, :, :27] < 1e19).sum())
    ok = equal_plain and equal_cache and untouched and alive > 0
    ms = cuda_time_ms(lambda: ck.champions_from_planes_lanes(*args, got), reps=100, warmup=5)
    plain_ms = cuda_time_ms(lambda: ck.champions_from_planes_lanes_plain(*args, plain), reps=5)
    with torch.no_grad():
        device_ms = cuda_graph_ms(lambda: ck.champions_from_planes_lanes(*args, got), launches=50)
    nbytes = b * (4.0 * (3 * kg * n + 3 * n + 3 * 27 * n) + n) + 4.0 * b
    flops = b * 8.0 * kg * n
    row = {
        "name": "champions_from_planes", "route": "cuda", "ok": ok,
        "source": "vfmreg_tpu_torch/csrc/champions_from_planes.cu",
        "replaces": "vfmreg_tpu/ops/champion_kernel.py:81",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **_bound(nbytes, flops, peaks),
        "library_ms": None,
    }
    row["shape"] = [b, kg, n]
    emit({"phase": "kernel_check", "path": path, "kernel": "champions_from_planes", "entry": "lanes",
          "group": group, "equal_plain": equal_plain, "equal_build_nn_cache": equal_cache,
          "unflagged_lane_untouched": untouched,
          "alive_champions": alive, "device_ms": device_ms, "gbytes_per_s": nbytes / ms / 1e6,
          "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"champions_from_planes_lanes disagrees: plain {equal_plain}, build_nn_cache "
                           f"{equal_cache}, untouched {untouched}, alive {alive}")
    return row, got


def check_gn_lanes(path, champs, src, mask, kernel, max_dist, peaks):
    """Lane-batched kernel B2, one GN step of every lane of `path`'s ICP row
    (champs [3, B, 32, N] from B3 at the lanes' positions src [B, N, 3],
    each lane right after a rebuild): each lane's moments within
    MOMENT_RTOL of the sum of the absolute values of its terms; the
    finishing stage fed the kernel's own moments against
    `gn_finish_lanes_plain` on the card: dx, est, T and the lane state bit
    for bit; each lane's moved source bit for bit against the plain move in
    the kernel's order and within GN_SRC_ULPS of `transform_points` by the
    plain est. Timed with every lane kept live."""
    import torch

    from vfmreg_tpu_torch.geometry.se3 import transform_points
    from vfmreg_tpu_torch.ops import gn_kernel as gk
    from vfmreg_tpu_torch.registration.icp import ESTIMATION_THRESHOLD as THR
    from vfmreg_tpu_torch.registration.icp import REFRESH_INTERVAL as R

    t0 = time.perf_counter()
    b, n = src.shape[:2]
    k = champs.shape[2]
    dev = src.device
    center = (torch.where(mask[..., None], src, 0.0).sum(dim=1) / mask.sum(dim=1)[:, None]).contiguous()
    r_max = torch.sqrt(torch.amax(torch.where(mask, ((src - center[:, None]) ** 2).sum(-1), 0.0), dim=1))
    st0 = gk.new_gn_lanes(torch.eye(4).repeat(b, 1, 1), 0, 1000, r_max, 0.5, n)
    st0.ints[:, gk.PHASE] = gk.STEP
    st_k, st_p = st0.clone(), st0.clone()
    src_k = src.clone()
    step = (champs[0], champs[1], champs[2])
    gk.gn_step_lanes(*step, src_k, center, kernel, max_dist, THR, R, st_k)
    terms = [gk.gn_terms_plain(champs[0, j], champs[1, j], champs[2, j], src[j], center[j], kernel, max_dist)
             for j in range(b)]
    m_p = torch.stack([t.sum(dim=1) for t in terms])
    scale = torch.stack([t.abs().sum(dim=1) for t in terms])
    live = gk.lanes_live(st_p, THR, R)
    gk.gn_finish_lanes_plain(st_k.moments.clone(), st_p, center, live, THR, R)
    # The plain moves by the plain est: `transform_points`, and the kernel's
    # order ((x R_i0 + y R_i1) + z R_i2) + t_i, one rounding per operation.
    est = st_p.est
    by_tp = torch.stack([transform_points(src[j], est[j]) if live[j] else src[j] for j in range(b)])
    Rm, t = est[:, None, :3, :3], est[:, None, :3, 3]
    x, y, z = src[..., 0:1], src[..., 1:2], src[..., 2:3]
    by_order = torch.where(live[:, None, None], ((x * Rm[..., 0] + y * Rm[..., 1]) + z * Rm[..., 2]) + t, src)
    torch.cuda.synchronize()
    diff = (st_k.moments - m_p).abs()
    moments_ok = bool(torch.all(diff <= MOMENT_RTOL * scale)) and bool((m_p[:, 0] > 0).all())
    errs = {key: float((a - c).abs().max()) for key, a, c in (
        ("dx", st_k.dx, st_p.dx), ("est", st_k.est, est), ("T", st_k.T, st_p.T),
        ("src_order", src_k, by_order), ("src_transform_points", src_k, by_tp))}
    f = torch.finfo(torch.float32)
    ulp = (f.eps * by_tp.abs().amax(dim=-1, keepdim=True)).clamp(min=f.tiny)
    src_ulps = float(((src_k - by_tp).abs() / ulp).max())
    finish_equal = all(torch.equal(a, c) for a, c in (
        (st_k.dx, st_p.dx), (st_k.est, est), (st_k.T, st_p.T), (st_k.floats, st_p.floats)))
    flags_equal = torch.equal(st_k.ints, st_p.ints)
    moved = bool(live.all()) and torch.equal(src_k, by_order) and src_ulps <= GN_SRC_ULPS
    ok = moments_ok and finish_equal and flags_equal and moved

    # Timing: every lane kept live (no budget, no slack, no refresh limit).
    st_t = st0.clone()
    st_t.ints[:, gk.MAX_IT] = 2**30
    st_t.floats[:, gk.SLACK] = float("inf")
    src_t = src.clone()
    args = (*step, src_t, center, kernel, max_dist, 0.0, 2**30, st_t)
    ms = cuda_time_ms(lambda: gk.gn_step_lanes(*args), reps=200, warmup=10)
    with torch.no_grad():
        device_ms = cuda_graph_ms(lambda: gk.gn_step_lanes(*args))
    still_live = bool(gk.lanes_live(st_t, 0.0, 2**30).all())
    src_p, st_pt = src.clone(), st_t.clone()
    plain_ms = cuda_time_ms(lambda: gk.gn_step_lanes_plain(*step, src_p, center, kernel, max_dist, 0.0, 2**30,
                                                           st_pt), reps=5)
    nbytes = b * 4.0 * (3 * k * n + 6 * n + 3 + 16 + 16 + 17)
    flops = b * (float(n) * (8 * k + 75) + 600)
    row = {
        "name": "gn_moments_from_cache", "route": "cuda", "ok": ok, "source": "vfmreg_tpu_torch/csrc/gn_moments.cu",
        "replaces": "vfmreg_tpu/ops/gn_kernel.py:98",
        "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms, **_bound(nbytes, flops, peaks),
        "library_ms": None,
    }
    row["shape"] = [b, k, n]
    emit({"phase": "kernel_check", "path": path, "kernel": "gn_moments_from_cache", "entry": "gn_step_lanes",
          "kernel_width": kernel, "max_dist": max_dist, "moments_ok": moments_ok,
          "max_rel_err_of_scale": float((diff / scale.clamp(min=1e-30)).max()),
          "max_abs_errs": errs, "src_ulps_from_transform_points": src_ulps, "finish_equal": finish_equal, "flags_equal": flags_equal, "moved_ok": moved,
          "accepted": m_p[:, 0].tolist(), "phases_after_step": st_k.ints[:, gk.PHASE].tolist(),
          "timed_lanes_stayed_live": still_live, "device_ms": device_ms,
          "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"gn_step_lanes disagrees: moments {moments_ok} ({diff.max().item()}), finish "
                           f"{finish_equal}, errors {errs} ({src_ulps} ulp), flags {flags_equal}: {st_k.ints.tolist()} vs "
                           f"{st_p.ints.tolist()}, moved {moved}")
    return row


def cuda_cold_ms(fn, kernel, launches=NN_COLD_LAUNCHES):
    """(event ms, kernel ms, kernel records) of one call of `fn` with a cold
    L2, each time the median over `launches` calls. Before each call a FLUSH_BYTES buffer is
    read (its sum: the H100's 50 MB L2 then holds none of the inputs and no
    dirty line to write back), and a spin kernel of SPIN_CYCLES keeps the
    card busy while the host enqueues the call. The event time is taken
    between two events around the call, so it holds the launch's own
    latency; the kernel time is CUPTI's record of the kernel whose name
    holds `kernel` (`torch.profiler`, a second round of calls), the kernel
    alone."""
    import statistics

    import torch
    from torch.autograd import DeviceType

    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")
    fn()

    def cold_call():
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        return start, end

    events = [cold_call() for _ in range(launches)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            cold_call()
        torch.cuda.synchronize()
    kernel_ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
    # CUPTI may drop some records of a long run (40 of 50 seen on an H100);
    # the median of those it kept stands, half of them at least.
    if not launches // 2 <= len(kernel_ms) <= launches:
        raise RuntimeError(f"the profiler recorded {len(kernel_ms)} launches of {kernel}, of {launches}")
    return statistics.median(s.elapsed_time(e) for s, e in events), statistics.median(kernel_ms), len(kernel_ms)


def check_nn_argmin(path, cx, cy, cz, source, peaks):
    """Kernel B4 against its plain version, bit for bit, on one champion
    cache cx, cy, cz [K, n] of `path` with its lane's positions [n, 3],
    plus one NaN query (column 0) and one empty neighbourhood (column 1,
    every champion the sentinel). Timed four ways: `ms`, CUDA events
    around back-to-back wrapper calls (the host's cost included);
    `device_ms`, the calls captured in one CUDA graph (warm L2); `cold_ms`
    and `cold_kernel_ms`, single calls after an L2 flush by events and by
    the profiler's kernel record (`cuda_cold_ms`)."""
    import torch

    from vfmreg_tpu_torch.ops.hash_grid import INVALID_COORD
    from vfmreg_tpu_torch.ops.nn_kernel import NO_ROW, nn_argmin, nn_argmin_plain

    t0 = time.perf_counter()
    cx, cy, cz = (c.clone() for c in (cx, cy, cz))
    for c in (cx, cy, cz):
        c[:, 1] = INVALID_COORD
    q = source.clone()
    q[0] = float("nan")
    args = (cx, cy, cz, q)
    d2_k, k_k = nn_argmin(*args)
    d2_p, k_p = nn_argmin_plain(*args)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(d2_k), torch.isnan(d2_p)
    same_d2 = torch.equal(nan_k, nan_p) and torch.equal(
        d2_k[~nan_k].view(torch.int32), d2_p[~nan_p].view(torch.int32))
    same_k = torch.equal(k_k, k_p)
    probes = bool(nan_k[0]) and int(k_k[0]) == NO_ROW and bool(torch.isinf(d2_k[1])) and int(k_k[1]) == 0
    finite = int(torch.isfinite(d2_k).sum())
    ok = same_d2 and same_k and probes and finite > q.shape[0] // 2
    fin = torch.isfinite(d2_k) & torch.isfinite(d2_p)
    err = float((d2_k[fin] - d2_p[fin]).abs().max())
    ms = cuda_time_ms(lambda: nn_argmin(*args), reps=200, warmup=10)
    with torch.no_grad():
        device_ms = cuda_graph_ms(lambda: nn_argmin(*args))
    cold_ms, cold_kernel_ms, cold_records = cuda_cold_ms(lambda: nn_argmin(*args), "nn_argmin_kernel")
    plain_ms = cuda_time_ms(lambda: nn_argmin_plain(*args), reps=20)
    k, n = cx.shape
    nbytes = 4.0 * (3 * k * n + 3 * n) + 8.0 * n
    row = {
        "name": "nn_argmin", "route": "cuda", "ok": ok, "source": "vfmreg_tpu_torch/csrc/nn_argmin.cu",
        "replaces": "vfmreg_tpu/ops/nn_kernel.py:44",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **_bound(nbytes, 8.0 * k * n, peaks),
        "library_ms": None, "device_ms": device_ms, "cold_ms": cold_ms, "cold_kernel_ms": cold_kernel_ms,
        "host_ms": ms - device_ms,
        "launches_note": "no path of either package calls nn_from_cache: every ICP row takes the fused B2",
    }
    row["shape"] = [k, n]
    emit({"phase": "kernel_check", "path": path, "kernel": "nn_argmin", "equal_d2": same_d2,
          "equal_k": same_k, "nan_and_empty_probes": probes, "finite_queries": finite,
          "gbytes_per_s": nbytes / ms / 1e6, "device_gbytes_per_s": nbytes / device_ms / 1e6,
          "cold_kernel_gbytes_per_s": nbytes / cold_kernel_ms / 1e6, "cold_kernel_records": cold_records,
          "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"nn_argmin disagrees with its plain version at {row['shape']}: d2 {same_d2}, "
                           f"k {same_k}, probes {probes}, finite {finite}")
    return row


def check_flash(path, q, k, v, peaks):
    """Kernel B5 against the einsum softmax on q, k, v [B, T, H, hd]."""
    import torch
    import torch.nn.functional as F

    from vfmreg_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    t0 = time.perf_counter()
    got = flash_attention(q, k, v)
    ref = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    ok = err <= ATTN_ATOL and bool(torch.isfinite(got).all())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = cuda_time_ms(lambda: flash_attention(q, k, v), reps=200, warmup=10)
    plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v), reps=50, warmup=5)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps=200, warmup=10)
    # Back-to-back calls of a kernel this short time the host's launch cost
    # as much as the card: the device's own time, from a CUDA graph, beside.
    with torch.no_grad():
        device_ms = cuda_graph_ms(lambda: flash_attention(q, k, v))
        library_device_ms = cuda_graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    b, t, h, hd = q.shape
    flops = 4.0 * b * h * t * t * hd
    row = {
        "name": "flash_attention", "route": "cuda", "ok": ok,
        "source": "vfmreg_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vfmreg_tpu/ops/flash_attention.py:56",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **_bound_3xtf32(4 * 4.0 * b * t * h * hd, flops, peaks), "library_ms": library_ms,
    }
    row["shape"] = [b, t, h, hd]
    emit({"phase": "kernel_check", "path": path, "kernel": "flash_attention", "gflops": flops / ms / 1e6,
          "device_ms": device_ms, "library_device_ms": library_device_ms,
          "seconds": time.perf_counter() - t0, **row})
    if not ok:
        raise RuntimeError(f"flash_attention disagrees with its plain version at {row['shape']}: err={err}")
    return row


def drive_descriptor(dev, peaks, rows):
    """The descriptor phase: B5 checked on the pass's own q, k, v (block 0 of
    the first image) and on unit normals, then the pass once, counted, timed
    and gated, and once more with plain attention for the cosine gate."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator, preprocess_image
    from vfmreg_tpu_torch.models.vit import PRESETS
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors
    from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig, make_rig_cloud

    t0 = time.perf_counter()
    gen = ImageFeatureGenerator("dinov2", config=PRESETS[VIT_PRESET], seed=SEED, device=dev)
    rig = SyntheticCameraRig(seed=SEED)
    clouds = [make_rig_cloud(N_SCAN, seed=SEED + i) for i in range(BATCH)]
    files = [[f"cloud{i}/{cam}.png" for cam in rig.cameras] for i in range(BATCH)]
    emit({"phase": "descriptor_data", "seconds": time.perf_counter() - t0, "clouds": BATCH,
          "points": N_SCAN, "cameras": len(rig.cameras), "image": [rig.height, rig.width, 3],
          "vit": VIT_PRESET, "parameters": sum(p.numel() for p in gen.model.parameters())})

    first = rig.read_images(files[0])[rig.cameras[0]]
    batch, _ = preprocess_image(first, gen.patch_size, gen.patch_h, dev)
    with torch.no_grad():
        blk = gen.model.blocks[0]
        q, k, v = blk.attn.qkv(blk.norm1(gen.model.tokens(batch)))
    rows["flash_attention"] = check_flash("descriptor", q, k, v, peaks)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    check_flash("unit_normal", *(torch.randn((2, 200, 4, 32), generator=g).to(dev) for _ in range(3)), peaks)
    # T a multiple of the kernel's 32-key tile and 16-query tile: no padding key.
    check_flash("key_tile_multiple", *(torch.randn((1, 320, 6, 64), generator=g).to(dev) for _ in range(3)),
                peaks)
    del q, k, v, batch

    def run(generator):
        return [create_descriptors(f, rig, generator, c) for f, c in zip(files, clouds)]

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    descs = run(gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_images = BATCH * len(rig.cameras)

    t1 = time.perf_counter()
    plain = run(ImageFeatureGenerator(
        params=gen.model.state_dict(), config=dataclasses.replace(gen.config, use_flash_attention=False),
        device=dev))
    plain_seconds = time.perf_counter() - t1

    covered_ok, cos_min, max_abs, n_covered, n_expected = True, 1.0, 0.0, 0, 0
    for f, c, d, dp in zip(files, clouds, descs, plain):
        seen, first_empty = rig.coverage(c, rig.read_images(f))
        expected = (seen > 0) & ~first_empty
        covered = np.any(d != 0, axis=1)
        covered_ok &= bool(np.array_equal(covered, expected))
        n_covered += int(covered.sum())
        n_expected += int(expected.sum())
        a, b = d[expected].astype(np.float64), dp[expected].astype(np.float64)
        cos = (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-300)
        cos_min = min(cos_min, float(cos.min()))
        max_abs = max(max_abs, float(np.abs(d - dp).max()))
    launches_ok = launches.get("flash_attention", 0) == VIT_LAYERS * n_images
    ok = covered_ok and launches_ok and cos_min >= DESC_COS
    emit({"phase": "descriptor", "ok": ok, "seconds": seconds, "images": n_images,
          "images_per_s": n_images / seconds, "points_per_s": BATCH * N_SCAN / seconds,
          "plain_attention_seconds": plain_seconds, "covered_points": n_covered,
          "expected_covered_points": n_expected, "coverage_exact": covered_ok,
          "min_cosine_vs_plain_attention": cos_min, "max_abs_diff_vs_plain_attention": max_abs,
          "launches": launches, "peak_memory_bytes": peak})
    if not covered_ok:
        raise RuntimeError(f"descriptor coverage differs from the rig's projection: {n_covered} vs {n_expected}")
    if not launches_ok:
        raise RuntimeError(f"the descriptor pass did not launch B5 {VIT_LAYERS} x {n_images} times: {launches}")
    if cos_min < DESC_COS:
        raise RuntimeError(f"descriptors disagree with plain attention: min cosine {cos_min}")
    return launches


def drive_descriptor_vitg14(dev, peaks, rows):
    """The descriptor_vitg14 phase: B5 checked on the pass's own q, k, v
    [1, 325, 24, 64] (block 0 of the first image), then the pass over the
    BATCH clouds once, counted (B5 launches, the ViT's images and tokens),
    timed and gated (coverage exact, finite), and the first cloud once more
    with plain attention for the cosine gate."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.models import vit
    from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator, preprocess_image
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors
    from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig, make_rig_cloud

    t0 = time.perf_counter()
    cfg = vit.PRESETS[VITG_PRESET]
    model = vit.init_vit(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    gen = ImageFeatureGenerator("dinov2", config=cfg, params=model.state_dict(), device=dev)
    del model
    rig = SyntheticCameraRig(seed=SEED)
    clouds = [make_rig_cloud(N_SCAN, seed=SEED + i) for i in range(BATCH)]
    files = [[f"cloud{i}/{cam}.png" for cam in rig.cameras] for i in range(BATCH)]
    torch.cuda.synchronize()
    emit({"phase": "descriptor_vitg14_data", "seconds": time.perf_counter() - t0, "clouds": BATCH,
          "points": N_SCAN, "cameras": len(rig.cameras), "image": [rig.height, rig.width, 3], "vit": VITG_PRESET,
          "parameters": sum(p.numel() for p in gen.model.parameters()),
          "weights_bytes": torch.cuda.memory_allocated()})

    first = rig.read_images(files[0])[rig.cameras[0]]
    batch, _ = preprocess_image(first, gen.patch_size, gen.patch_h, dev)
    with torch.no_grad():
        blk = gen.model.blocks[0]
        q, k, v = blk.attn.qkv(blk.norm1(gen.model.tokens(batch)))
    rows["flash_attention"] = check_flash("descriptor_vitg14", q, k, v, peaks)
    del q, k, v, batch

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    counts = dict(vit.FORWARD_COUNTS)
    t0 = time.perf_counter()
    descs = [create_descriptors(f, rig, gen, c) for f, c in zip(files, clouds)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    forwarded = {k: vit.FORWARD_COUNTS[k] - counts.get(k, 0) for k in ("images", "tokens")}
    peak = torch.cuda.max_memory_allocated()
    n_images = BATCH * len(rig.cameras)

    plain_gen = ImageFeatureGenerator(params=gen.model.state_dict(),
                                      config=dataclasses.replace(cfg, use_flash_attention=False), device=dev)
    plain = create_descriptors(files[0], rig, plain_gen, clouds[0])
    del plain_gen

    covered_ok, finite, n_covered = True, True, 0
    for f, c, d in zip(files, clouds, descs):
        seen, first_empty = rig.coverage(c, rig.read_images(f))
        covered = np.any(d != 0, axis=1)
        covered_ok &= bool(np.array_equal(covered, (seen > 0) & ~first_empty))
        finite &= bool(np.isfinite(d).all())
        n_covered += int(covered.sum())
    cos_min = float(_cosines(descs[0][np.any(plain != 0, axis=1)], plain[np.any(plain != 0, axis=1)]).min())
    launches_ok = launches.get("flash_attention", 0) == VITG_LAYERS * n_images
    counted_ok = forwarded == {"images": n_images, "tokens": n_images * VITG_TOKENS}
    ok = covered_ok and finite and launches_ok and counted_ok and cos_min >= DESC_COS
    emit({"phase": "descriptor_vitg14", "ok": ok, "seconds": seconds, "images": n_images,
          "images_per_s": n_images / seconds, "scans_per_s": BATCH / seconds, "covered_points": n_covered,
          "coverage_exact": covered_ok, "finite": finite, "forwarded": forwarded,
          "min_cosine_vs_plain_attention": cos_min, "launches": launches, "peak_memory_bytes": peak})
    if not (covered_ok and finite):
        raise RuntimeError(f"ViT-g descriptors: coverage exact {covered_ok}, finite {finite}")
    if not (launches_ok and counted_ok):
        raise RuntimeError(f"the ViT-g pass launched B5 {launches} times and forwarded {forwarded}")
    if cos_min < DESC_COS:
        raise RuntimeError(f"ViT-g descriptors disagree with plain attention: min cosine {cos_min}")
    return launches


def _cosines(a, b):
    """Row-wise cosine of two [N, D] arrays, in float64."""
    import numpy as np

    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(1) / np.maximum(np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-300)


def drive_descriptor_maskclip(dev, peaks, rows):
    """The descriptor_maskclip phase: the descriptor pass with MaskCLIP at
    ViT-B/16 full width. B5 checked on its own q, k, v (block 0 of the first
    image), then the pass once, counted, timed and gated; the first cloud
    also evaluated on the CPU. Returns the launches, the descriptors and the
    generator."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator, preprocess_image
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline.prepare_scenes import create_descriptors
    from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig, make_rig_cloud

    t0 = time.perf_counter()
    gen = ImageFeatureGenerator("maskclip", seed=SEED, device=dev)
    cfg = gen.config
    rig = SyntheticCameraRig(seed=SEED)
    clouds = [make_rig_cloud(N_SCAN, seed=SEED + i) for i in range(BATCH)]
    files = [[f"cloud{i}/{cam}.png" for cam in rig.cameras] for i in range(BATCH)]
    emit({"phase": "descriptor_maskclip_data", "seconds": time.perf_counter() - t0, "clouds": BATCH,
          "points": N_SCAN, "cameras": len(rig.cameras), "image": [rig.height, rig.width, 3],
          "maskclip": dataclasses.asdict(cfg), "parameters": sum(p.numel() for p in gen.model.parameters())})

    first = rig.read_images(files[0])[rig.cameras[0]]
    batch, _ = preprocess_image(first, gen.patch_size, gen.patch_h, dev)
    with torch.no_grad():
        blk = gen.model.transformer.resblocks[0]
        q, k, v = blk.attn.qkv(blk.ln_1(gen.model.tokens(batch)))
    rows["flash_attention"] = check_flash("descriptor_maskclip", q, k, v, peaks)
    del q, k, v, batch

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    descs = [create_descriptors(f, rig, gen, c) for f, c in zip(files, clouds)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_images = BATCH * len(rig.cameras)

    # The port's own CPU evaluation of the same generator and weights (B5's
    # plain version) on the first cloud.
    t1 = time.perf_counter()
    cpu_gen = ImageFeatureGenerator("maskclip", params={k: v.cpu() for k, v in gen.model.state_dict().items()},
                                    config=cfg, device="cpu")
    cpu_desc = create_descriptors(files[0], rig, cpu_gen, clouds[0])
    cpu_seconds = time.perf_counter() - t1

    covered_ok, n_covered, n_expected = True, 0, 0
    for f, c, d in zip(files, clouds, descs):
        seen, first_empty = rig.coverage(c, rig.read_images(f))
        expected = (seen > 0) & ~first_empty
        covered = np.any(d != 0, axis=1)
        covered_ok &= bool(np.array_equal(covered, expected))
        n_covered += int(covered.sum())
        n_expected += int(expected.sum())
        if c is clouds[0]:
            first_expected = expected
    cos = _cosines(descs[0][first_expected], cpu_desc[first_expected])
    cos_min = float(cos.min())
    max_abs = float(np.abs(descs[0] - cpu_desc).max())
    width_ok = all(d.shape == (N_SCAN, cfg.embed_dim) for d in descs) and cfg.embed_dim == 512
    softmax_blocks = cfg.num_layers - 1  # the last block is value-only
    launches_ok = launches.get("flash_attention", 0) == softmax_blocks * n_images
    ok = covered_ok and launches_ok and width_ok and cos_min >= DESC_COS
    emit({"phase": "descriptor_maskclip", "ok": ok, "seconds": seconds, "images": n_images,
          "images_per_s": n_images / seconds, "points_per_s": BATCH * N_SCAN / seconds,
          "descriptor_width": int(descs[0].shape[1]), "covered_points": n_covered,
          "expected_covered_points": n_expected, "coverage_exact": covered_ok,
          "cpu_seconds_first_cloud": cpu_seconds, "min_cosine_vs_cpu": cos_min,
          "max_abs_diff_vs_cpu": max_abs, "launches": launches, "peak_memory_bytes": peak})
    if not width_ok:
        raise RuntimeError(f"MaskCLIP descriptors are not 512-d: {[d.shape for d in descs]}")
    if not covered_ok:
        raise RuntimeError(f"descriptor coverage differs from the rig's projection: {n_covered} vs {n_expected}")
    if not launches_ok:
        raise RuntimeError(f"the MaskCLIP pass did not launch B5 {softmax_blocks} x {n_images} times: {launches}")
    if cos_min < DESC_COS:
        raise RuntimeError(f"MaskCLIP descriptors disagree with the CPU evaluation: min cosine {cos_min}")
    return launches, descs, gen


def drive_featup(dev):
    """The featup phase: `get_image_features(upsample=True)` with
    `use_featup=True` on the first cloud's five images at DINOv2 ViT-S/14,
    once with seeded learned-stack parameters (FeatUp's JBU stack, then
    bilinear to the image) and once without (the classical JBU at the
    image's resolution), each timed per image and counted; the stack's
    [16h, 16w, 384] output for the first image held against the port's CPU
    evaluation of the same function."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.models import featup
    from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator, preprocess_image
    from vfmreg_tpu_torch.models.vit import PRESETS
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline.synthetic import SyntheticCameraRig

    rig = SyntheticCameraRig(seed=SEED)
    images = list(rig.read_images([f"cloud0/{cam}.png" for cam in rig.cameras]).values())
    cfg = PRESETS[VIT_PRESET]
    stack_sd = featup.init_jbu_stack(cfg.hidden_size, torch.Generator().manual_seed(SEED), device="cpu").state_dict()
    learned = ImageFeatureGenerator("dinov2", use_featup=True, config=cfg, seed=SEED, featup_params=stack_sd,
                                    device=dev)
    classical = ImageFeatureGenerator("dinov2", use_featup=True, config=cfg, params=learned.model.state_dict(),
                                      device=dev)

    out = {}
    for name, gen in (("learned", learned), ("classical", classical)):
        _build.reset_launches()
        secs, finite = [], True
        for img in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = gen.get_image_features(img, upsample=True)
            secs.append(time.perf_counter() - t0)
            finite &= feats.shape == (rig.height, rig.width, cfg.hidden_size) and bool(np.isfinite(feats).all())
            del feats
        out[name] = {"seconds_per_image": secs, "shape_and_finite": finite,
                     "stack": gen._featup_stack is not None, "launches": dict(_build.LAUNCHES)}

    batch, _ = preprocess_image(images[0], learned.patch_size, learned.patch_h, dev)
    with torch.no_grad():
        feats = learned.model(batch)["patches"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hr = featup.jbu_stack_upsample(learned._featup_stack, feats, batch[0])
    torch.cuda.synchronize()
    stack_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    hr_cpu = featup.jbu_stack_upsample(featup.stack_from_state_dict(stack_sd, device="cpu"), feats.cpu(),
                                       batch[0].cpu())
    cpu_seconds = time.perf_counter() - t0
    err = float((hr.cpu() - hr_cpu).abs().max())
    scale = float(hr_cpu.abs().max())
    h, w = feats.shape[:2]
    shape_ok = tuple(hr.shape) == (16 * h, 16 * w, cfg.hidden_size)
    launches_ok = all(o["launches"].get("flash_attention", 0) == VIT_LAYERS * len(images) for o in out.values())
    branches_ok = out["learned"]["stack"] and not out["classical"]["stack"]
    ok = (shape_ok and err <= FEATUP_ATOL and launches_ok and branches_ok
          and all(o["shape_and_finite"] for o in out.values()))
    emit({"phase": "featup", "ok": ok, "images": len(images), **out, "stack_shape": list(hr.shape),
          "stack_seconds": stack_seconds, "stack_cpu_seconds": cpu_seconds, "stack_max_abs_err_vs_cpu": err,
          "stack_max_abs": scale, "atol": FEATUP_ATOL})
    if not ok:
        raise RuntimeError(f"featup phase failed: err={err}, shape {tuple(hr.shape)}, {out}")


def drive_clip_text(dev, gen, descriptors):
    """The clip_text phase: CLIP's text tower at full width (seeded random
    weights) attached to the MaskCLIP generator, a few prompts encoded on
    the card and held against the port's CPU evaluation, and
    `compute_similarity` of the first cloud's MaskCLIP descriptors against
    one of them."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.models.clip_text import CLIPText, CLIPTextConfig, SimpleTokenizer, init_clip_text

    cfg = CLIPTextConfig()
    sd = init_clip_text(cfg, torch.Generator().manual_seed(SEED), device="cpu").state_dict()
    tokenizer = SimpleTokenizer()
    gen.set_text_encoder(sd, cfg, tokenizer)
    cpu_model = CLIPText(cfg)
    cpu_model.load_state_dict(sd)
    prompts = ["a photo of a car", "a road", "a building facade", "a tree beside the street", "the sky"]

    emb, secs = [], []
    for p in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb.append(gen.encode_text(p))
        secs.append(time.perf_counter() - t0)
    emb = np.stack(emb)
    with torch.no_grad():
        ref = cpu_model.eval()(torch.from_numpy(tokenizer.tokenize(prompts, cfg.context_length))).numpy()
    err = float(np.abs(emb - ref).max())

    t0 = time.perf_counter()
    sims = gen.compute_similarity(descriptors, prompts[0])
    sim_seconds = time.perf_counter() - t0
    zero = ~np.any(descriptors != 0, axis=1)
    finite = bool(np.isfinite(sims).all())
    in_range = bool(np.abs(sims).max() <= 1.0 + SIM_RANGE_SLACK)
    zeros_ok = bool(np.all(sims[zero] == 0.0)) and int(zero.sum()) > 0
    ok = err <= TEXT_ATOL and emb.shape == (len(prompts), cfg.embed_dim) and finite and in_range and zeros_ok
    emit({"phase": "clip_text", "ok": ok, "prompts": len(prompts), "config": dataclasses.asdict(cfg),
          "seconds_per_prompt": secs, "max_abs_err_vs_cpu": err, "atol": TEXT_ATOL,
          "embedding_max_abs": float(np.abs(ref).max()), "similarity_seconds": sim_seconds,
          "similarity_min": float(sims.min()), "similarity_max": float(sims.max()), "finite": finite,
          "zero_rows": int(zero.sum()), "zero_rows_zero": zeros_ok})
    if not ok:
        raise RuntimeError(f"clip_text phase failed: err={err}, finite {finite}, range {in_range}, zeros {zeros_ok}")


@contextlib.contextmanager
def gc_pauses():
    """{"collections": [per generation], "seconds": [per generation]}: the
    host's garbage-collector passes in the block and their time."""
    import gc

    out = {"collections": [0, 0, 0], "seconds": [0.0, 0.0, 0.0]}
    started = []

    def clock(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            out["collections"][info["generation"]] += 1
            out["seconds"][info["generation"]] += time.perf_counter() - started.pop()

    gc.callbacks.append(clock)
    try:
        yield out
    finally:
        gc.callbacks.remove(clock)


def drive_train(dev, peaks, rows):
    """The train phase: the trainer's dp x tp step at world size 1 through
    NCCL (a one-rank group over a FileStore, a (1, 1) ("data", "model")
    mesh, so every collective of the split step runs), at ViT-S/14 full
    width with plain attention and the adapter 384 -> 512 -> 128.

    * step 1 (the warm-up) against the port's CPU step from the same
      parameters on the same batch, and against the same step with
      `mesh=None` on the card, bit for bit;
    * TRAIN_STEPS timed steps (a synchronize after each): steps/s, images/s,
      median / p90 step seconds, peak memory; the loss finite at every step
      and lower after them than at step 1;
    * a checkpoint after step TRAIN_CKPT_STEP restored into a fresh state,
      whose next step equals the uninterrupted step bit for bit (loss,
      parameters, moments);
    * TRAIN_CLOCK_STEPS steps with the stage clock (forward, backward,
      gradient all-reduce, optimizer; a synchronize after each) and their
      collectives recorded; the host's garbage-collector pauses in the
      timed steps;
    * `make_train_step` with `use_flash_attention=True` raises B5's "no
      backward" error, and the steps launch B5 0 times;
    * B5 at the trainer's shape [16, 321, 6, 64] (block 0 of the trained
      ViT on both views), then the trained ViT's forward under `no_grad`
      with B5 (`models.vit.ViT` loaded from the gathered state): 12
      launches, patch descriptors within cosine DESC_COS of the plain
      attention's. Returns the forward's launches."""
    import datetime
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from vfmreg_tpu_torch.models.vit import PRESETS, ViT
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.parallel import collectives
    from vfmreg_tpu_torch.parallel.mesh import make_mesh
    from vfmreg_tpu_torch.train import trainer as T
    from vfmreg_tpu_torch.utils.profiling import Timer

    t_phase = time.perf_counter()
    vit_cfg = dataclasses.replace(PRESETS[VIT_PRESET], use_flash_attention=False)
    flash_cfg = dataclasses.replace(vit_cfg, use_flash_attention=True)
    tcfg = T.TrainConfig()
    rng = np.random.RandomState(SEED)
    h, w = TRAIN_HW
    ia = rng.normal(size=(TRAIN_PAIRS, h, w, 3)).astype(np.float32)
    ib = ia + 0.05 * rng.normal(size=ia.shape).astype(np.float32)
    patches = (h // vit_cfg.patch_size) * (w // vit_cfg.patch_size)
    idx = rng.randint(0, patches, (TRAIN_PAIRS, TRAIN_K)).astype(np.int32)
    batch = [torch.from_numpy(x).to(dev) for x in (ia, ib, idx)]

    def new_state(mesh, seed=SEED, cfg=vit_cfg, device=dev):
        return T.create_train_state(torch.Generator().manual_seed(seed), cfg, mesh, tcfg, device)[0]

    def snapshot(state, m):
        named = dict(state.model.named_parameters())
        return {"loss": m["loss"].clone(), "accuracy": m["accuracy"].clone(),
                "grads": {n: p.grad.detach().clone() for n, p in named.items()},
                "params": {n: p.detach().clone() for n, p in named.items()},
                "exp_avg_sq": {n: state.optimizer.state[p]["exp_avg_sq"].clone() for n, p in named.items()}}

    def differs(a, b):
        """The snapshot entries (`key` or `key:name`) that are not equal bit for bit."""
        out = [k for k in ("loss", "accuracy") if not torch.equal(a[k], b[k])]
        return out + [f"{key}:{n}" for key in ("grads", "params", "exp_avg_sq") for n in a[key]
                      if not torch.equal(a[key][n], b[key][n])]

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, world_size=1, rank=0, timeout=datetime.timedelta(seconds=120),
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            backend = dist.get_backend()
            mesh = make_mesh(("data", "model"), (1, 1))
            step = T.make_train_step(vit_cfg, mesh, tcfg)
            state = new_state(mesh)
            n_params = sum(p.numel() for p in state.model.parameters())
            _build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, *batch)
            torch.cuda.synchronize()
            warmup_seconds = time.perf_counter() - t0
            first = snapshot(state, m)
            losses, times = [float(m["loss"])], []
            with gc_pauses() as pauses:
                for _ in range(TRAIN_STEPS):
                    t0 = time.perf_counter()
                    state, m = step(state, *batch)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(float(m["loss"]))
                    if state.step == TRAIN_CKPT_STEP:
                        ckpt = T.save_checkpoint(os.path.join(tmp, "ckpt"), state)
                    if state.step == TRAIN_CKPT_STEP + 1:
                        after_ckpt = snapshot(state, m)
            peak = torch.cuda.max_memory_allocated()
            clocks = []
            with collectives.recording() as log:
                for _ in range(TRAIN_CLOCK_STEPS):
                    timer = Timer()
                    state, m = step(state, *batch, timer=timer)
                    clocks.append(timer.totals)
                torch.cuda.synchronize()
            coll = collectives.collective_ms(log)
            coll_by_op = dict(collections.Counter(r["op"] for r in log))
            stage_ms = {k: [1e3 * c[k] for c in clocks] for k in clocks[0]}
            full = T.full_state(state)["params"]

            fresh = T.restore_checkpoint(ckpt, new_state(mesh, seed=SEED + 1))
            resumed_from = fresh.step
            fresh, m = step(fresh, *batch)
            resume_diff = differs(snapshot(fresh, m), after_ckpt)
            resume_equal = resumed_from == TRAIN_CKPT_STEP and not resume_diff
            del fresh
        finally:
            dist.destroy_process_group()

    single = new_state(None)
    single, m = T.make_train_step(vit_cfg, None, tcfg)(single, *batch)
    mesh_diff = differs(snapshot(single, m), first)
    mesh_equal = not mesh_diff
    del single

    raised = ""
    flash_state = new_state(None, cfg=flash_cfg)
    try:
        T.make_train_step(flash_cfg, None, tcfg)(flash_state, *batch)
    except ValueError as e:
        raised = str(e)
    flash_refused = "no backward" in raised and flash_state.step == 0
    # Every training step above, the refused one included (launch counts are
    # reset before step 1 only).
    b5_in_steps = _build.LAUNCHES.get("flash_attention", 0)
    del flash_state
    torch.cuda.empty_cache()

    # Step 1 on the CPU from the same parameters on the same batch.
    t0 = time.perf_counter()
    cpu = new_state(None, device="cpu")
    cpu, cm = T.make_train_step(vit_cfg, None, tcfg)(cpu, ia, ib, idx)
    cpu_seconds = time.perf_counter() - t0
    cpu_grads = {n: p.grad for n, p in cpu.model.named_parameters()}
    top = max(float(g.abs().max()) for g in cpu_grads.values())
    grad_rel, zero_grad = {}, 0.0
    for n, g in cpu_grads.items():
        card = first["grads"][n].cpu()
        if n.endswith("attn.k.bias"):
            zero_grad = max(zero_grad, float(card.abs().max()) / top, float(g.abs().max()) / top)
        else:
            grad_rel[n] = float((card - g).abs().max()) / float(g.abs().max())
    loss_rel = abs(float(first["loss"]) - float(cm["loss"])) / float(cm["loss"])
    acc_diff = abs(float(first["accuracy"]) - float(cm["accuracy"]))
    worst = max(grad_rel, key=grad_rel.get)
    cpu_ok = (loss_rel <= TRAIN_LOSS_RTOL and acc_diff <= TRAIN_ACC_ATOL
              and grad_rel[worst] <= TRAIN_GRAD_RTOL and zero_grad <= TRAIN_ZERO_GRAD_RTOL)
    del cpu, cpu_grads

    # B5 at the trainer's shape, on the trained weights.
    images = torch.cat(batch[:2])
    vit_sd = {k[len("vit."):]: v for k, v in full.items() if k.startswith("vit.")}
    models = {}
    for name, cfg in (("flash", flash_cfg), ("plain", vit_cfg)):
        models[name] = ViT(cfg)
        models[name].load_state_dict(vit_sd)
        models[name].to(dev).eval()
    with torch.no_grad():
        blk = models["flash"].blocks[0]
        q, k, v = blk.attn.qkv(blk.norm1(models["flash"].tokens(images)))
    rows["flash_attention"] = check_flash("train", q, k, v, peaks)
    del q, k, v
    _build.reset_launches()
    with torch.no_grad():
        out_flash = models["flash"](images)["patches"]
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        out_plain = models["plain"](images)["patches"]
    a = out_flash.reshape(-1, out_flash.shape[-1]).double()
    b = out_plain.reshape(-1, out_plain.shape[-1]).double()
    cos_min = float(((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-300)).min())
    forward_ok = launches.get("flash_attention", 0) == VIT_LAYERS and cos_min >= DESC_COS

    steps_per_s = len(times) / sum(times)
    finite = bool(np.all(np.isfinite(losses)))
    descends = losses[-1] < losses[0]
    ok = (finite and descends and cpu_ok and mesh_equal and resume_equal and flash_refused and b5_in_steps == 0
          and forward_ok and coll["calls"] > 0)
    emit({"phase": "train", "ok": ok, "backend": backend, "world_size": 1, "mesh": {"data": 1, "model": 1},
          "vit": VIT_PRESET, "parameters": n_params, "train_config": dataclasses.asdict(tcfg),
          "pairs": TRAIN_PAIRS, "image": [h, w, 3], "tokens": patches + 1, "k": TRAIN_K,
          "logits": [TRAIN_PAIRS * TRAIN_K] * 2, "warmup_seconds": warmup_seconds, "steps": len(times),
          "steps_per_s": steps_per_s, "images_per_s": 2 * TRAIN_PAIRS * steps_per_s,
          "step_seconds_median": float(np.median(times)), "step_seconds_p90": float(np.percentile(times, 90)),
          "step_seconds": times, "peak_memory_bytes": peak, "losses": losses, "loss_finite": finite,
          "loss_descends": descends, "gc_pauses_in_timed_steps": pauses,
          "stage_ms_median": {k: float(np.median(v)) for k, v in stage_ms.items()}, "stage_ms": stage_ms,
          "collective_calls_per_step": coll["calls"] / TRAIN_CLOCK_STEPS,
          "collective_ms_per_step": coll["ms"] / TRAIN_CLOCK_STEPS,
          "collectives_by_op": {k: v / TRAIN_CLOCK_STEPS for k, v in coll_by_op.items()},
          "flash_attention_launches_in_steps": b5_in_steps, "flash_attention_step_refused": raised,
          "mesh_step_equals_single_device": mesh_equal, "mesh_step_differs": mesh_diff[:8],
          "checkpoint_step": TRAIN_CKPT_STEP, "resume_equal": resume_equal, "resume_differs": resume_diff[:8],
          "cpu_seconds": cpu_seconds, "cpu_pairs": TRAIN_PAIRS,
          "loss_card": float(first["loss"]), "loss_cpu": float(cm["loss"]), "loss_rel_diff": loss_rel,
          "accuracy_card": float(first["accuracy"]), "accuracy_cpu": float(cm["accuracy"]),
          "grad_max_rel_diff": grad_rel[worst], "grad_worst_leaf": worst, "k_bias_grad_over_top": zero_grad,
          "tolerances": {"loss_rtol": TRAIN_LOSS_RTOL, "accuracy_atol": TRAIN_ACC_ATOL,
                         "grad_rtol": TRAIN_GRAD_RTOL, "zero_grad_rtol": TRAIN_ZERO_GRAD_RTOL},
          "flash_forward_launches": launches, "min_cosine_flash_vs_plain": cos_min,
          "seconds": time.perf_counter() - t_phase, "nvidia_smi": nvidia_smi()})
    if not ok:
        raise RuntimeError(
            f"train phase failed: finite {finite}, descends {descends} ({losses[0]} -> {losses[-1]}), cpu {cpu_ok} "
            f"(loss {loss_rel}, acc {acc_diff}, grad {worst} {grad_rel[worst]}, k bias {zero_grad}), mesh = single "
            f"{mesh_equal}, resume {resume_equal}, flash refused {flash_refused} ({raised!r}), B5 in steps "
            f"{b5_in_steps}, forward {launches} cos {cos_min}, collectives {coll}")
    return launches


def drive_driver(dev, peaks, rows):
    """The driver phase: every kernel checked at the driver's shapes (into
    `rows`), then the method row once, counted, timed and gated."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.ops.voxel import bucket_size
    from vfmreg_tpu_torch.pipeline import registration_node as rn
    from vfmreg_tpu_torch.pipeline.synthetic import make_synthetic_scene
    from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ, champion_group
    from vfmreg_tpu_torch.config import INITIAL_THRESHOLD, VOXEL_SIZE
    from vfmreg_tpu_torch.ops.matching import l2_normalize

    t0 = time.perf_counter()
    scene, local_map, true_poses = make_synthetic_scene(BATCH, N_MAP, N_SCAN, DIM, seed=SEED)
    # Device-resident scene, as bench.py's driver workload keeps it: the
    # map and the stacked scans are on the card before the row starts.
    raw, raw_mask = rn.stack_scans(scene["scene_point_clouds"], local_map.shape[1])
    scene["scene_point_clouds_device"] = (torch.from_numpy(raw).to(dev), torch.from_numpy(raw_mask).to(dev))
    lm = torch.from_numpy(local_map).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "driver_data", "seconds": time.perf_counter() - t0, "map": list(local_map.shape),
          "scans": list(raw.shape), "scan_points": [int(c.shape[0]) for c in scene["scene_point_clouds"]]})

    # Kernel inputs at the row's shapes. B1: the 5 m queries of all B scans,
    # flattened as the row's matching hands them over (q5_budget rows per
    # scan, most of them padding), against the map grid's descriptors. B2
    # and B3: one slab gather of every scan at the vanilla row's start (the
    # identity), at the row's ICP width W, with the vanilla row's kernel.
    grid = rn.build_map_grid(lm, VOXEL_SIZE, dev)
    p3, _, m3, counts3, _, q5f, q5m, _ = rn._preprocess_scans_device(
        *scene["scene_point_clouds_device"], VOXEL_SIZE, 2048)
    qn = l2_normalize(q5f.reshape(-1, DIM)).contiguous()
    rows["cosine_argmax"] = check_cosine("driver", qn, l2_normalize(grid.feats).contiguous(),
                                         grid.valid, q5m.reshape(-1), peaks)
    del qn, q5f
    w = min(bucket_size(int(counts3.max())), p3.shape[1])
    src, mask = p3[:, :w].contiguous(), m3[:, :w].contiguous()
    group = champion_group(grid)
    planes, caches = lane_planes(grid, src, mask, group)
    rows["champions_from_planes"], champs = check_champions_lanes("driver", planes, src, mask, group, caches,
                                                                  peaks)
    del planes
    rows["gn_moments_from_cache"] = check_gn_lanes("driver", champs, src, mask, INITIAL_THRESHOLD / 7,
                                                   7 * INITIAL_THRESHOLD, peaks)
    cache = (caches[0].cx, caches[0].cy, caches[0].cz)
    rows["nn_argmin"] = check_nn_argmin("driver", *cache, src[0], peaks)
    rows["nn_argmin_k7"] = check_nn_argmin("driver_k7", *(c[:NN_SMALL_K].contiguous() for c in cache), src[0],
                                           peaks)
    del grid, p3, m3, caches, champs, cache
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = rn.precompute_scene_batched(scene, lm, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    st = res["stats"]
    errs = {k: [compute_errors(p, t) for p, t in zip(res[key], true_poses)]
            for k, key in (("gt", "gt"), ("vfm_ransac", "vfm_ransac_ortho"),
                           ("vfm_ransac_icp", "vfm_ransac_icp"), ("icp", "icp"))}
    gated = ("gt", "vfm_ransac_icp")
    lanes_ok = all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for k in gated for rte, rre in errs[k])
    gn_iterations = sum(sum(v) for v in st["iterations"].values())
    rebuilds = sum(sum(v) for v in st["rebuilds"].values())
    loops = {row: loop_check(st["loop"][row], st["iterations"][row], st["rebuilds"][row], GN_STEPS_PER_READ,
                             max(st["iterations"][row])) for row in st["loop"]}
    step_calls = sum(v["step_calls"] for v in loops.values())
    rebuild_rounds = sum(v["rebuild_rounds"] for v in loops.values())
    launches_ok = (launches.get("cosine_argmax", 0) >= 1
                   and launches.get("gn_moments_from_cache", 0) == step_calls
                   and rebuilds > 0 and launches.get("champions_from_planes", 0) == rebuild_rounds
                   and all(v["ok"] for v in loops.values()))
    table = rn.recall_table(rn.method_errors(res))

    # A second call, under VFMREG_PROFILE_DRIVER (its seconds by stage): the
    # same poses, iterations and rebuilds, bit for bit.
    import io

    profile_out = io.StringIO()
    with env_switch("VFMREG_PROFILE_DRIVER"), contextlib.redirect_stdout(profile_out):
        again = rn.precompute_scene_batched(scene, lm, device=dev)
    repeat_ok = (all(np.array_equal(res[k], again[k]) for k in ("gt", "vfm_ransac_raw", "vfm_ransac_icp", "icp"))
                 and all(st[k] == again["stats"][k] for k in ("iterations", "rebuilds", "settled", "loop")))
    emit({"phase": "driver", "ok": lanes_ok and launches_ok and repeat_ok, "seconds": seconds,
          "reg_per_s": BATCH / seconds, "batch": BATCH, "map_points": N_MAP, "scan_points": N_SCAN,
          "dim": DIM, "stage_seconds": again["stats"]["seconds"],
          "stage_seconds_of": "the second call, under VFMREG_PROFILE_DRIVER=1",
          "profile_line": profile_out.getvalue().strip(), "icp_width": st["icp_width"],
          "corr_width": st["corr_width"], "corr_counts": res["corr_counts"],
          "snap_counts": res["snap_counts"], "scan_sizes": res["scan_sizes"], "retried": res["retried"],
          "rte_m": {k: [e[0] for e in v] for k, v in errs.items()},
          "rre_deg": {k: [e[1] for e in v] for k, v in errs.items()},
          "iterations": st["iterations"], "settled": st["settled"], "rebuilds": st["rebuilds"],
          "gn_iterations": gn_iterations, "champion_rebuilds": rebuilds, "launches": launches,
          "gn_steps_per_read": GN_STEPS_PER_READ, "icp_rows": loops,
          "repeat_bit_identical": repeat_ok,
          "recall_vs_gt_icp": {k: dict(zip([f"{t},{r}" for t, r in rn.THRESHOLDS], v))
                               for k, v in table.items()},
          "vanilla_recall_vs_true": float(np.mean([rte < RTE_GATE_M and rre < RRE_GATE_DEG
                                                   for rte, rre in errs["icp"]])),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not lanes_ok:
        raise RuntimeError(f"driver recall gate failed: {errs}")
    if not launches_ok:
        raise RuntimeError(f"the driver row did not go through every kernel as counted: {launches}, "
                           f"B2 step calls {step_calls}, B3 rebuild rounds {rebuild_rounds}, rows {loops}")
    if not repeat_ok:
        raise RuntimeError("a second driver call gave other poses, iterations or rebuilds")
    del scene["scene_point_clouds_device"], raw, raw_mask
    drive_driver_paths(dev, scene, lm, true_poses)
    del lm
    torch.cuda.empty_cache()
    return launches, (scene, local_map, true_poses)


def drive_driver_paths(dev, scene, lm, true_poses):
    """The driver row's two rare paths at full width, each gated like the
    driver phase (GT ICP and vfm RANSAC + ICP on every lane): the 1 m retry,
    with scan RETRY_SCAN cropped to an 8 m radius (a handful of 5 m voxels,
    below 75 correspondences), and the query-budget re-match, with a budget
    of 4 queries per scan (every scan re-matched at full width)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline import registration_node as rn

    cropped = list(scene["scene_point_clouds"])
    c = cropped[RETRY_SCAN]
    cropped[RETRY_SCAN] = c[np.linalg.norm(c[:, :2], axis=1) < 8.0]
    for name, scn, budget in (("retry", dict(scene, scene_point_clouds=cropped), 2048),
                              ("rematch", scene, 4)):
        _build.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with env_switch("VFMREG_PROFILE_DRIVER"), contextlib.redirect_stdout(out):
            res = rn.precompute_scene_batched(scn, lm, device=dev, q5_budget=budget)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        errs = {k: [compute_errors(p, t) for p, t in zip(res[k], true_poses)] for k in ("gt", "vfm_ransac_icp")}
        lanes_ok = all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for v in errs.values() for rte, rre in v)
        if name == "retry":
            taken = res["retried"] == [RETRY_SCAN]
        else:
            taken = "re-matching them at full width" in out.getvalue() and res["retried"] == []
        # B1: the 5 m pass, then the retry's or the re-match's pass.
        b1_ok = launches.get("cosine_argmax", 0) == 2
        emit({"phase": f"driver_{name}", "ok": lanes_ok and taken and b1_ok, "seconds": seconds,
              "q5_budget": budget, "retried": res["retried"], "path_taken": taken,
              "corr_counts": res["corr_counts"], "snap_counts": res["snap_counts"],
              "scan_sizes": res["scan_sizes"], "stage_seconds": res["stats"]["seconds"],
              "rte_m": {k: [e[0] for e in v] for k, v in errs.items()},
              "rre_deg": {k: [e[1] for e in v] for k, v in errs.items()}, "launches": launches})
        if not (lanes_ok and taken and b1_ok):
            raise RuntimeError(f"driver {name} path: taken {taken}, B1 launches {launches}, errors {errs}")


def check_serial_kernels(path, dev, peaks, rows, node, local_map, scan, gt_pose):
    """B1-B3 at a serial column's shapes: the scan's 5 m queries (after the
    node's 0.1 m and double voxelize) padded to a bucket against the grid of
    `local_map` (B1), and one lane at the scan's ICP width at `gt_pose` (B2,
    B3). Fills rows[kernel]; returns the map's VoxelHashMap."""
    import contextlib
    import io

    import numpy as np
    import torch

    from vfmreg_tpu_torch.kiss import get_voxel_hash_map, voxel_down_sample
    from vfmreg_tpu_torch.ops import matching
    from vfmreg_tpu_torch.ops.matching import l2_normalize
    from vfmreg_tpu_torch.ops.voxel import bucket_size
    from vfmreg_tpu_torch.registration.icp import champion_group

    with contextlib.redirect_stdout(io.StringIO()):
        vmap = get_voxel_hash_map(node.config, device=dev)
    vmap.add_points(local_map)
    grid = vmap.device_grid()
    dv = node._double_voxelize(voxel_down_sample(scan, 0.1))
    q5 = voxel_down_sample(dv, 5.0)
    n_q = bucket_size(q5.shape[0])
    qf = torch.zeros((n_q, q5.shape[1] - 3), device=dev)
    qf[: q5.shape[0]] = torch.from_numpy(q5[:, 3:]).to(dev)
    live = torch.arange(n_q, device=dev) < q5.shape[0]
    qn = torch.cat([l2_normalize(qf[i : i + matching._NORM_ROWS])
                    for i in range(0, n_q, matching._NORM_ROWS)]).contiguous()
    rows["cosine_argmax"] = check_cosine(path, qn, l2_normalize(grid.feats).contiguous(), grid.valid, live, peaks)
    w = bucket_size(dv.shape[0])
    src = torch.zeros((1, w, 3), device=dev)
    src[0, : dv.shape[0]] = torch.from_numpy((dv[:, :3] @ gt_pose[:3, :3].T + gt_pose[:3, 3]).astype(np.float32)).to(dev)
    mask = (torch.arange(w, device=dev) < dv.shape[0])[None]
    group = champion_group(grid)
    planes, caches = lane_planes(grid, src, mask, group)
    rows["champions_from_planes"], champs = check_champions_lanes(path, planes, src, mask, group, caches, peaks)
    sigma = node.config.adaptive_threshold.initial_threshold
    rows["gn_moments_from_cache"] = check_gn_lanes(path, champs, src, mask, sigma / 3, 3 * sigma, peaks)
    return vmap


def drive_node(dev, peaks, rows, scene, local_map, true_poses):
    """The node phase: the driver scene in a scene file's layout
    (`pipeline.synthetic.scene_file_layout`) through
    `RegistrationNode.run_scene` with the vfm RANSAC and TEASER columns,
    batched (the card's default) and serial, each counted; the kernels at
    the serial column's own shapes; then `register_frame`'s VFM branch on
    one full-width scan with descriptors. Gates: recall (GT ICP against the
    true poses; vfm RANSAC + ICP and vfm TEASER + ICP against GT ICP, in the
    node's own tables), serial = batched (GT and vanilla ICP bit for bit,
    the RANSAC rows within SERIAL_RANSAC_ATOL), every kernel launched as the
    loops count, and one map point per occupied 0.25 m voxel."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.kiss import register_frame
    from vfmreg_tpu_torch.kiss.voxelization import _voxel_keys
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline.registration_node import RegistrationNode
    from vfmreg_tpu_torch.pipeline.synthetic import scene_file_layout
    from vfmreg_tpu_torch.registration import icp, teaser
    from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ

    t0 = time.perf_counter()
    layout = scene_file_layout(scene, local_map)
    occupied = int(np.unique(_voxel_keys(np.concatenate([c[:, :3] for c in layout["map_point_clouds"]]),
                                         0.25)).size)
    emit({"phase": "node_data", "seconds": time.perf_counter() - t0, "map_clouds":
          [list(c.shape) for c in layout["map_point_clouds"]], "occupied_0.25m_voxels": occupied})
    methods = dict(methods_ransac=[("vfm", True)], methods_teaser=[("vfm", True)], methods_pointdsc=[])
    runs = {}
    with tempfile.TemporaryDirectory() as empty:
        for mode, batch in (("batched", None), ("serial", False)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                node = RegistrationNode(empty, device=dev, batch_scans=batch, **methods)
            if node.batch_scans != (mode == "batched"):
                raise RuntimeError(f"node: batch_scans={node.batch_scans} in the {mode} run")
            gts, maps = {}, []
            score, accumulate = node.compute_errors, node._accumulate_map

            def recording(gt_pose, pose, method, node=node, gts=gts, score=score):
                gts.setdefault(node.scan_idx, np.array(gt_pose))
                return score(gt_pose, pose, method)

            def keep_map(scn, maps=maps, accumulate=accumulate):
                maps.append(accumulate(scn))
                return maps[-1]

            node.compute_errors, node._accumulate_map = recording, keep_map
            torch.cuda.synchronize()
            _build.reset_launches()
            teaser.GNC_STEPS.clear()
            t0 = time.perf_counter()
            with env_switch("VFMREG_PROFILE_DRIVER"), contextlib.redirect_stdout(out), \
                    icp.recording_loops() as calls:
                node.run_scene(layout)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            runs[mode] = dict(node=node, gts=[gts[i] for i in sorted(gts)], seconds=seconds,
                              launches=dict(_build.LAUNCHES), calls=calls, map=maps[0], log=out.getvalue(),
                              gnc=dict(teaser.GNC_STEPS))

    ok_all = True
    for mode, r in runs.items():
        node, calls = r["node"], r["calls"]
        gt_errs = [compute_errors(p, t) for p, t in zip(r["gts"], true_poses)]
        gated = {m: list(zip(node.trans_errors[m], node.rot_errors[m])) for m in ("vfm_ransac_icp", "vfm_teaser_icp")}
        recall_ok = (len(gt_errs) == BATCH
                     and all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for rte, rre in gt_errs)
                     and all(len(v) == BATCH and all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for rte, rre in v)
                             for v in gated.values()))
        loop = collections.Counter()
        for c in calls:
            loop.update(c["loop"])
        loops = loop_check(loop, [i for c in calls for i in c["iterations"]],
                           [k for c in calls for k in c["rebuilds"]], GN_STEPS_PER_READ,
                           sum(max(c["iterations"]) for c in calls))
        b1_floor = node.vfm_searches + (1 if mode == "batched" else 0)
        launches = r["launches"]
        launches_ok = (launches.get("cosine_argmax", 0) >= b1_floor
                       and launches.get("gn_moments_from_cache", 0) == loop["step_calls"] > 0
                       and launches.get("champions_from_planes", 0) == loop["rebuild_rounds"] > 0
                       and loops["ok"])
        map_ok = r["map"].shape[0] == occupied
        ok = recall_ok and launches_ok and map_ok
        ok_all &= ok
        summary = r["log"].splitlines()[-12:]
        emit({"phase": f"node_{mode}", "ok": ok, "seconds": r["seconds"], "scans": BATCH,
              "stage_seconds": node.stage_seconds, "accumulated_map_points": int(r["map"].shape[0]),
              "occupied_0.25m_voxels": occupied, "map_ok": map_ok,
              "batched_row_stage_seconds": node.batched_stats["seconds"] if node.batched_stats else None,
              "gt_rte_m": [e[0] for e in gt_errs], "gt_rre_deg": [e[1] for e in gt_errs],
              "rte_m": dict(node.trans_errors), "rre_deg": dict(node.rot_errors),
              "recall": {m: [node.compute_success_rate(m, *t) for t in ((0.3, 15), (0.6, 1.5), (2, 5))]
                         for m in node.rot_errors},
              "launches": launches, "serial_vfm_searches": node.vfm_searches, "b1_floor": b1_floor,
              "icp_calls": len(calls), "icp_loops": loops,
              "gnc_steps": {"per_scene": r["gnc"].get("steps", 0), "solves": r["gnc"].get("solves", 0),
                            "per_solve": r["gnc"].get("steps", 0) / max(r["gnc"].get("solves", 0), 1),
                            "steps_per_read": teaser.GNC_STEPS_PER_READ},
              "summary": summary})
        if not ok:
            raise RuntimeError(f"node {mode}: recall {recall_ok} (GT {gt_errs}, {gated}), launches {launches_ok} "
                               f"({launches}, floor {b1_floor}, {loops}), map {r['map'].shape[0]} vs {occupied}")

    # Serial = batched, scan by scan.
    sb, ss = runs["batched"]["node"], runs["serial"]["node"]
    gt_equal = all(np.array_equal(a, b) for a, b in zip(runs["batched"]["gts"], runs["serial"]["gts"]))
    icp_equal = sb.trans_errors["icp"] == ss.trans_errors["icp"] and sb.rot_errors["icp"] == ss.rot_errors["icp"]
    ransac_gap = max(abs(a - b) for m in ("vfm_ransac", "vfm_ransac_icp") for e in ("trans_errors", "rot_errors")
                     for a, b in zip(getattr(sb, e)[m], getattr(ss, e)[m]))
    teaser_equal = all(getattr(sb, e)[m] == getattr(ss, e)[m] for m in ("vfm_teaser", "vfm_teaser_icp")
                       for e in ("trans_errors", "rot_errors"))
    same_ok = gt_equal and icp_equal and ransac_gap <= SERIAL_RANSAC_ATOL
    emit({"phase": "node_serial_vs_batched", "ok": same_ok, "gt_bit_identical": gt_equal,
          "icp_bit_identical": icp_equal, "ransac_max_abs_gap": ransac_gap, "teaser_identical": teaser_equal})
    if not same_ok:
        raise RuntimeError(f"node: serial != batched (GT {gt_equal}, icp {icp_equal}, RANSAC gap {ransac_gap})")

    # The kernels at the serial column's shapes.
    node = runs["serial"]["node"]
    sigma = node.config.adaptive_threshold.initial_threshold
    vmap = check_serial_kernels("node", dev, peaks, rows, node, runs["serial"]["map"],
                                layout["scene_point_clouds"][0], runs["serial"]["gts"][0])

    # register_frame's VFM branch: scan 1 with its descriptors, from its stored pose.
    _build.reset_launches()
    t0 = time.perf_counter()
    with icp.recording_loops() as calls:
        pose = register_frame(layout["scene_point_clouds"][1], vmap, layout["scene_poses"][1], 3 * sigma,
                              sigma / 3)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rte, rre = compute_errors(pose, true_poses[1])
    launches = dict(_build.LAUNCHES)
    vfm_ok = (rte < RTE_GATE_M and rre < RRE_GATE_DEG and len(calls) == 1
              and launches.get("cosine_argmax", 0) == 1
              and launches.get("gn_moments_from_cache", 0) == calls[0]["loop"]["step_calls"]
              and launches.get("champions_from_planes", 0) == calls[0]["loop"]["rebuild_rounds"])
    emit({"phase": "node_register_frame_vfm", "ok": vfm_ok, "seconds": seconds, "points": int(
          layout["scene_point_clouds"][1].shape[0]), "rte_m": rte, "rre_deg": rre, "launches": launches,
          "icp_loop": calls})
    if not vfm_ok:
        raise RuntimeError(f"register_frame's VFM branch: rte {rte}, rre {rre}, launches {launches}")
    return runs["batched"]["launches"]


def _rows_equal(a, b, keys):
    """The keys of two driver-row results that differ (arrays bit for bit)."""
    import numpy as np

    return [k for k in keys if not (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k])]


def kept_rows(points, voxel_size, cap):
    """The rows [K, 3] of points [M, 3] that a grid with `cap` points a voxel
    keeps: the first `cap` of each voxel in row order (`build_hash_grid`),
    in row order."""
    import torch

    from vfmreg_tpu_torch.ops.voxel import voxel_coords

    _, inv = torch.unique(voxel_coords(points, voxel_size), dim=0, return_inverse=True)
    order = torch.sort(inv, stable=True).indices
    sorted_inv = inv[order]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=points.device) - torch.searchsorted(sorted_inv, sorted_inv)
    return points[rank < cap]


def lane_champions(grid, src, mask, group):
    """B3 over every lane at its position: champion planes [3, B, 32, N]."""
    import torch

    from vfmreg_tpu_torch.ops import champion_kernel as ck
    from vfmreg_tpu_torch.ops.gn_kernel import REBUILT

    planes, _ = lane_planes(grid, src, mask, group)
    b, n = src.shape[:2]
    out = ck.new_champion_buffer(b, n, src.device)
    ck.champions_from_planes_lanes(planes[0], planes[1], planes[2], src, mask,
                                   torch.full((b,), REBUILT, dtype=torch.int32, device=src.device), group, out)
    return out


def gn_step_fresh(champs, src, mask, kernel, max_dist):
    """One B2 step of every lane right after a rebuild at refresh_interval=1
    (the state of check_gn_lanes): (lane state, moved sources)."""
    import torch

    from vfmreg_tpu_torch.ops import gn_kernel as gk
    from vfmreg_tpu_torch.registration.icp import ESTIMATION_THRESHOLD

    b, n = src.shape[:2]
    center = (torch.where(mask[..., None], src, 0.0).sum(dim=1) / mask.sum(dim=1)[:, None]).contiguous()
    r_max = torch.sqrt(torch.amax(torch.where(mask, ((src - center[:, None]) ** 2).sum(-1), 0.0), dim=1))
    st = gk.new_gn_lanes(torch.eye(4).repeat(b, 1, 1), 0, 1000, r_max, 0.5, n)
    st.ints[:, gk.PHASE] = gk.STEP
    moved = src.clone()
    gk.gn_step_lanes(champs[0], champs[1], champs[2], moved, center, kernel, max_dist, ESTIMATION_THRESHOLD, 1, st)
    return st, moved


def drive_node_sharded(dev, peaks, rows, scene, local_map, true_poses):
    """The node_sharded phase: the driver row's multi-device modes at world
    size 1 on one card, through NCCL (a one-rank group over a FileStore in a
    temporary directory), on the driver scene (full width, seed 0).

    * the single-device row in turns without and with
      VFMREG_PROFILE_DRIVER (the per-stage barriers' cost), the two equal
      bit for bit, and once with VFMREG_PROFILE_ICP_ITERS (its vanilla row
      one full-budget loop);
    * `precompute_scene_batched(mesh=)` scan-sharded
      (`sharded_driver_stages`) and map-sharded (`map_sharded_driver_stages`,
      the map's rows on the one rank): every pose and count equal bit for
      bit to the single-device row's, but the map-sharded vanilla row, one
      full-budget loop as the reference runs it, equal bit for bit to the
      row under VFMREG_PROFILE_ICP_ITERS; GT and RANSAC + ICP lanes within
      the recall gate; B1-B3 launched as the loops count; the collective
      calls counted and timed by CUDA events;
    * `RegistrationNode(map_sharding=True)` on the node scene cut to
      NODE_SHARDED_SCANS scans equal to the default node (at world size 1
      both take the single-device path, as the reference's do);
    * B2 at the merged widths K = 32 x world (world 2 and 4): the driver
      map's stored rows (the first 20 of each voxel, so no shard can hold
      more than the one grid) split into contiguous blocks, one grid each,
      B3 at every driver lane's start per block, the planes concatenated as
      `parallel.mesh.CacheMerge` does: the kernel against its plain version
      (check_gn_lanes), and one GN step at refresh_interval=1 equal bit for
      bit to the one grid's step, every query's nearest champion distance
      equal."""
    import datetime
    import io
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from vfmreg_tpu_torch.config import INITIAL_THRESHOLD, MAX_POINTS_PER_VOXEL, VOXEL_SIZE
    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
    from vfmreg_tpu_torch.ops.voxel import bucket_size
    from vfmreg_tpu_torch.parallel import collectives
    from vfmreg_tpu_torch.parallel.mesh import make_mesh
    from vfmreg_tpu_torch.pipeline import registration_node as rn
    from vfmreg_tpu_torch.pipeline.synthetic import scene_file_layout
    from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ, champion_group

    t_phase = time.perf_counter()
    raw, raw_mask = rn.stack_scans(scene["scene_point_clouds"], local_map.shape[1])
    scn = dict(scene, scene_point_clouds_device=(torch.from_numpy(raw).to(dev), torch.from_numpy(raw_mask).to(dev)))
    lm = torch.from_numpy(local_map).to(dev)
    keys = ("gt", "vfm_ransac_raw", "vfm_ransac_ortho", "vfm_ransac_icp", "icp", "corr_counts", "snap_counts",
            "map_size", "scan_sizes", "retried")

    def row(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = rn.precompute_scene_batched(scn, lm, device=dev, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # The barriers' cost: the single-device row in turns, off, on, on, off.
    barrier = {"off": [], "on": []}
    results = {}
    for turn in ("off", "on", "on", "off", "off", "on"):
        with env_switch("VFMREG_PROFILE_DRIVER") if turn == "on" else contextlib.nullcontext():
            results[turn], secs = row()
        barrier[turn].append(secs)
    plain = results["off"]
    switch_diff = _rows_equal(results["on"], plain, keys)
    with env_switch("VFMREG_PROFILE_ICP_ITERS"):
        one_loop, _ = row()
    icp_switch_diff = _rows_equal(one_loop, plain, [k for k in keys if k != "icp"])

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, world_size=1, rank=0, timeout=datetime.timedelta(seconds=120),
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            meshes = {"scan_sharded": {"mesh": make_mesh(("data",))},
                      "map_sharded": {"mesh": make_mesh(("model",)), "map_sharded": True}}
            for name, kw in meshes.items():
                row(**kw)  # warm-up: the first collectives set up the communicator
                _build.reset_launches()
                with collectives.recording() as log:
                    res, secs = row(**kw)
                runs[name] = dict(res=res, seconds=secs, launches=dict(_build.LAUNCHES),
                                  collectives=collectives.collective_ms(log),
                                  by_op=dict(collections.Counter(r["op"] for r in log)))
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()

    ok_all = switch_diff == [] and icp_switch_diff == []
    by_path = None
    for name, r in runs.items():
        res, st = r["res"], r["res"]["stats"]
        diff = _rows_equal(res, plain, [k for k in keys if not (name == "map_sharded" and k == "icp")])
        if name == "map_sharded":
            diff += ["icp (against the one full-budget loop)"] * (not np.array_equal(res["icp"], one_loop["icp"]))
        errs = {k: [compute_errors(p, t) for p, t in zip(res[k], true_poses)] for k in ("gt", "vfm_ransac_icp")}
        lanes_ok = all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for v in errs.values() for rte, rre in v)
        loops = {k: loop_check(st["loop"][k], st["iterations"][k], st["rebuilds"][k], GN_STEPS_PER_READ,
                               max(st["iterations"][k])) for k in st["loop"]}
        launches = r["launches"]
        launches_ok = (launches.get("cosine_argmax", 0) >= 1
                       and launches.get("gn_moments_from_cache", 0) == sum(v["step_calls"] for v in loops.values())
                       and launches.get("champions_from_planes", 0) == sum(v["rebuild_rounds"] for v in loops.values())
                       and all(v["ok"] for v in loops.values()))
        ok = diff == [] and lanes_ok and launches_ok and r["collectives"]["calls"] > 0
        ok_all &= ok
        emit({"phase": f"node_sharded_{name}", "ok": ok, "backend": backend, "world_size": 1,
              "seconds": r["seconds"], "single_device_seconds": barrier["off"], "differs_from_single_device": diff,
              "collective_calls": r["collectives"]["calls"], "collective_ms": r["collectives"]["ms"],
              "collectives_by_op": r["by_op"], "launches": launches, "icp_rows": loops,
              "rte_m": {k: [e[0] for e in v] for k, v in errs.items()},
              "rre_deg": {k: [e[1] for e in v] for k, v in errs.items()}})
        by_path = launches
        if not ok:
            raise RuntimeError(f"node_sharded {name}: differs {diff}, recall {lanes_ok} ({errs}), launches "
                               f"{launches_ok} ({launches}, {loops}), collectives {r['collectives']}")

    # The node with map_sharding at world size 1 against the default node.
    layout = scene_file_layout(scene, local_map)
    layout = dict(layout, scene_poses=layout["scene_poses"][:NODE_SHARDED_SCANS],
                  scene_point_clouds=layout["scene_point_clouds"][:NODE_SHARDED_SCANS])
    nodes = {}
    methods = dict(methods_ransac=[("vfm", True)], methods_teaser=[], methods_pointdsc=[])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as empty, contextlib.redirect_stdout(io.StringIO()):
        for name, kw in (("default", {}), ("map_sharding", {"map_sharding": True})):
            node = rn.RegistrationNode(empty, device=dev, **methods, **kw)
            node.run_scene(layout)
            nodes[name] = node
    node_seconds = time.perf_counter() - t0
    a, b = nodes["default"], nodes["map_sharding"]
    node_ok = (a.trans_errors == b.trans_errors and a.rot_errors == b.rot_errors and b.mesh is None
               and len(a.trans_errors["vfm_ransac_icp"]) == NODE_SHARDED_SCANS)
    emit({"phase": "node_sharded_node", "ok": node_ok, "scans": NODE_SHARDED_SCANS, "seconds": node_seconds,
          "equal": node_ok, "rte_m": b.trans_errors, "rre_deg": b.rot_errors})
    ok_all &= node_ok

    # B2 at the merged widths.
    sigma = INITIAL_THRESHOLD
    grid = rn.build_map_grid(lm, VOXEL_SIZE, dev)
    p3, _, m3, counts3, *_ = rn._preprocess_scans_device(*scn["scene_point_clouds_device"], VOXEL_SIZE, 2048)
    w = min(bucket_size(int(counts3.max())), p3.shape[1])
    src, mask = p3[:, :w].contiguous(), m3[:, :w].contiguous()
    group = champion_group(grid)
    kept = kept_rows(lm[:, :3].contiguous(), VOXEL_SIZE, MAX_POINTS_PER_VOXEL)
    kept_ok = kept.shape[0] == int(grid.valid.sum())
    one = lane_champions(grid, src, mask, group)
    st_one, moved_one = gn_step_fresh(one, src, mask, sigma / 7, 7 * sigma)
    merged_out = {}
    for world in MERGED_WORLDS:
        rows_w = -(-kept.shape[0] // world) * world
        pts = torch.zeros((rows_w, 3), dtype=torch.float32, device=dev)
        pts[: kept.shape[0]] = kept
        valid = torch.arange(rows_w, device=dev) < kept.shape[0]
        k = rows_w // world
        merged = torch.cat([lane_champions(build_hash_grid(pts[r * k : (r + 1) * k], VOXEL_SIZE,
                                                           mask=valid[r * k : (r + 1) * k],
                                                           max_points_per_voxel=MAX_POINTS_PER_VOXEL),
                                           src, mask, group) for r in range(world)], dim=2).contiguous()
        path = f"node_sharded_k{32 * world}"
        rows[path] = {"gn_moments_from_cache": check_gn_lanes(path, merged, src, mask, sigma / 7, 7 * sigma, peaks)}
        st_m, moved_m = gn_step_fresh(merged, src, mask, sigma / 7, 7 * sigma)

        def best_d2(c):
            d = [(c[i] - src[..., i][:, None, :]) ** 2 for i in range(3)]
            return torch.amin(d[0] + d[1] + d[2], dim=1)

        same_nn = torch.equal(best_d2(merged), best_d2(one))
        same_step = all(torch.equal(x, y) for x, y in ((st_m.moments, st_one.moments), (st_m.T, st_one.T),
                                                         (st_m.ints, st_one.ints), (moved_m, moved_one)))
        merged_out[path] = {"shape": list(merged.shape[1:]), "nearest_distances_equal": same_nn,
                            "step_equal_to_one_grid": same_step,
                            "max_abs_T_diff": float((st_m.T - st_one.T).abs().max())}
        ok_all &= same_nn and same_step
    emit({"phase": "node_sharded_merged_caches", "ok": kept_ok and ok_all, "kept_rows": int(kept.shape[0]),
          "one_grid_rows": int(grid.valid.sum()), "map_rows": int(lm.shape[0]), **merged_out})
    emit({"phase": "node_sharded", "ok": kept_ok and ok_all, "seconds": time.perf_counter() - t_phase,
          "single_device_seconds": barrier, "profile_driver_equal": switch_diff == [],
          "profile_icp_iters_equal_but_vanilla": icp_switch_diff == []})
    if not (kept_ok and ok_all):
        raise RuntimeError(f"node_sharded: switches {switch_diff} / {icp_switch_diff}, node {node_ok}, "
                           f"kept rows {kept_ok}, merged caches {merged_out}")
    return by_path


def exp_tree(rng, center_xy, colour, d, n=EXP_TREE_POINTS):
    """A planted tree [n, 3 + d]: a trunk (a third of the points) under a
    crown, the descriptor's columns 0-2 `colour` over 255, the rest small
    positive noise."""
    import numpy as np

    n_trunk = n // 3
    ang = rng.uniform(0, 2 * np.pi, n_trunk)
    rad = 0.3 * np.sqrt(rng.uniform(0, 1, n_trunk))
    trunk = np.c_[rad * np.cos(ang), rad * np.sin(ang), rng.uniform(0, 3, n_trunk)]
    v = rng.normal(size=(n - n_trunk, 3))
    v *= (2.0 * rng.uniform(0, 1, (n - n_trunk, 1)) ** (1 / 3)) / np.linalg.norm(v, axis=1, keepdims=True)
    xyz = np.r_[trunk, v + [0.0, 0.0, 5.0]] + [center_xy[0], center_xy[1], 0.0]
    feats = np.c_[np.tile(np.asarray(colour, np.float64) / 255.0, (n, 1)), rng.uniform(0.01, 0.1, (n, d - 3))]
    return np.c_[xyz, feats].astype(np.float32)


def exp_recolour(cloud):
    """Columns 0-2 of every descriptor set from the row's columns 3-5 (so a
    scan row, a copy of its map row, keeps matching it) into [0, 1] x
    [0.75, 1] x [0, 1], away from both tree colours; rows whose sum is not
    positive have their other columns negated, as scene_file_layout does."""
    import numpy as np

    out = cloud.copy()
    u = 0.5 + 0.5 * out[:, 6:9]
    out[:, 3:6] = np.c_[u[:, 0], 0.75 + 0.25 * u[:, 1], u[:, 2]]
    flip = out[:, 3:].sum(axis=1) <= 0
    out[flip, 6:] = -out[flip, 6:]
    return out


def exp_trees_left(m, centers):
    """How many planted trees keep a point of their colour in map m."""
    import numpy as np

    tree = np.zeros(m.shape[0], bool)
    for c in EXP_TREE_COLORS:
        tree |= np.abs(m[:, 3:6] - np.asarray(c, np.float32) / np.float32(255.0)).max(axis=1) < 1e-6
    return sum(bool(np.any(tree & (np.linalg.norm(m[:, :2] - c, axis=1) < 3.0))) for c in centers)


def drive_node_experiments(dev, peaks, rows, scene, local_map, true_poses):
    """The node_experiments phase: `RegistrationNode.run_scene` on the node's
    scene (first EXP_SCANS scans) in the reference's four experiment modes,
    serially (an experiment turns the batched row off), with the vfm RANSAC
    and TEASER columns (no PointDSC): cluster removal at EXP_REMOVAL_P on the
    map with EXP_TREES planted trees (the generator's PCA fit set on columns
    0-2), insertion of int(100 EXP_INSERT_P) clusters from EXP_INSERT_FILES
    .npy files, scan-to-scan "data" and "kitti" (EXP_KITTI_FRAMES
    SyntheticDrive sweeps written as .bin; the vfm columns skipped). Gates:
    HDBSCAN finds every planted tree; each scan's removal leaves some trees
    and takes some; `points_in_map` equals the same host helpers run again
    on the same map with the same draws; B1 launched at least once per
    serial vfm search, B2 once per ICP step call, B3 once per rebuild round,
    in every mode; every GT-ICP lane within the recall gate of its true pose
    (the KITTI pair's: the drive's motion between the two frames); every
    pose finite and rigid. Then
    B1-B3 at the removal's serial shapes (scan 0 on its first removed map).
    Prints seconds per mode, the experiment's host work (clustering and map
    edits) apart from the rest."""
    import contextlib
    import io
    import re
    import tempfile

    import numpy as np
    import torch

    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.models.image_features import ImageFeatureGenerator, TorchPCA
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline.registration_node import RegistrationNode
    from vfmreg_tpu_torch.pipeline.synthetic import SyntheticDrive, scene_file_layout
    from vfmreg_tpu_torch.registration import icp
    from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ

    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    d = local_map.shape[1] - 3
    layout = scene_file_layout(scene, local_map)
    layout = dict(layout, scene_poses=layout["scene_poses"][:EXP_SCANS],
                  scene_point_clouds=[exp_recolour(c) for c in layout["scene_point_clouds"][:EXP_SCANS]])
    true_poses = true_poses[:EXP_SCANS]
    # The trees 9-14 m from the scans' centres, in turn, at least 8 m apart.
    centers = []
    while len(centers) < EXP_TREES:
        r, a = rng.uniform(9, 14), rng.uniform(0, 2 * np.pi)
        c = true_poses[len(centers) % EXP_SCANS][:2, 3] + r * np.array([np.cos(a), np.sin(a)])
        if all(np.linalg.norm(c - o) >= 8.0 for o in centers):
            centers.append(c)
    centers = np.array(centers)
    trees = [exp_tree(rng, c, EXP_TREE_COLORS[k % 2], d) for k, c in enumerate(centers)]
    anchors = np.zeros((2, 3 + d), np.float32)
    anchors[:, :3] = [[-60.0, -60.0, 0.1], [-60.0, -59.0, 0.1]]
    anchors[1, 3:6] = 1.0
    anchors[:, 6:] = 0.05
    clouds = [exp_recolour(c) for c in layout["map_point_clouds"]]
    world = np.concatenate([anchors, *trees])
    left = world[:, 0] < 0  # the map clouds split at x = 0, posed at the identity
    layout["map_point_clouds"] = [np.r_[clouds[0], world[left]], np.r_[clouds[1], world[~left]]]

    gen = ImageFeatureGenerator("dinov2", device=dev)
    fit = TorchPCA(3)
    fit.mean_, fit.components_ = np.zeros((1, d), np.float32), np.eye(d, 3, dtype=np.float32)
    gen.fit_pca[3] = fit
    tmp = tempfile.TemporaryDirectory()
    clusters_dir, kitti_dir = os.path.join(tmp.name, "clusters"), os.path.join(tmp.name, "kitti")
    os.makedirs(clusters_dir)
    os.makedirs(kitti_dir)
    for k in range(EXP_INSERT_FILES):
        np.save(os.path.join(clusters_dir, f"tree_{k}.npy"),
                exp_tree(rng, rng.uniform(-2, 2, 2), EXP_TREE_COLORS[k % 2], d))
    drive = SyntheticDrive(n_frames=EXP_KITTI_FRAMES, seed=SEED)
    for i in range(EXP_KITTI_FRAMES):
        frame = drive[i]
        np.c_[frame, np.zeros(frame.shape[0], np.float32)].tofile(os.path.join(kitti_dir, f"{i:06d}.bin"))
    # The frames the KITTI mode draws (np.random seeded with SEED before it),
    # and each pair's true motion: frame i + 1 in frame i.
    np.random.seed(SEED)
    picks = [int(np.random.choice(EXP_KITTI_FRAMES - 10)) for _ in range(EXP_SCANS)]
    kitti_true = [np.linalg.inv(drive.gt_poses[i]) @ drive.gt_poses[i + 1] for i in picks]
    emit({"phase": "node_experiments_data", "seconds": time.perf_counter() - t0,
          "map_clouds": [list(c.shape) for c in layout["map_point_clouds"]], "trees": len(trees),
          "tree_points": EXP_TREE_POINTS, "kitti_frames": EXP_KITTI_FRAMES, "kitti_points": int(frame.shape[0])})

    modes = {
        "removal": dict(cluster_removal_prob=EXP_REMOVAL_P, feature_generator=gen),
        "insertion": dict(cluster_removal_prob=EXP_INSERT_P, cluster_insertion_dir=clusters_dir),
        "scan_to_scan_data": dict(scan_to_scan="data"),
        "scan_to_scan_kitti": dict(scan_to_scan="kitti", kitti_dir=kitti_dir),
    }
    methods = dict(methods_ransac=[("vfm", True)], methods_teaser=[("vfm", True)], methods_pointdsc=[])
    total = collections.Counter()
    removed_maps, acc_map, removal_gt0, removal_node = [], None, None, None
    with tempfile.TemporaryDirectory() as empty:
        for mode, kw in modes.items():
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                node = RegistrationNode(empty, device=dev, **methods, **kw)
            poses, gts, maps = {}, {}, []
            score, accumulate, remove = node.compute_errors, node._accumulate_map, node._apply_cluster_removal

            def recording(gt_pose, pose, method, node=node, gts=gts, poses=poses, score=score):
                gts.setdefault(node.scan_idx, np.array(gt_pose))
                poses.setdefault(method, []).append(np.array(pose))
                return score(gt_pose, pose, method)

            def keep_map(scn, maps=maps, accumulate=accumulate):
                maps.append(accumulate(scn))
                return maps[-1]

            def keep_removed(m, r, remove=remove):
                removed_maps.append(remove(m, r))
                return removed_maps[-1]

            node.compute_errors, node._accumulate_map, node._apply_cluster_removal = recording, keep_map, keep_removed
            np.random.seed(SEED)  # the KITTI frame's draw
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log), icp.recording_loops() as calls:
                node.run_scene(layout)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            total.update(launches)

            loop = collections.Counter()
            for c in calls:
                loop.update(c["loop"])
            loops = loop_check(loop, [i for c in calls for i in c["iterations"]],
                               [k for c in calls for k in c["rebuilds"]], GN_STEPS_PER_READ,
                               sum(max(c["iterations"]) for c in calls))
            launches_ok = (launches.get("cosine_argmax", 0) >= node.vfm_searches
                           and (node.vfm_searches > 0) == (mode != "scan_to_scan_kitti")
                           and launches.get("gn_moments_from_cache", 0) == loop["step_calls"] > 0
                           and launches.get("champions_from_planes", 0) == loop["rebuild_rounds"] > 0
                           and loops["ok"])
            gt_list = [gts[i] for i in sorted(gts)]
            rigid = {k: max(float(np.abs(p[:3, :3].T @ p[:3, :3] - np.eye(3)).max()) for p in v)
                     for k, v in poses.items()}
            rigid_ok = (all(np.all(np.isfinite(p)) for v in poses.values() for p in v)
                        and all(v < RIGID_ATOL for v in rigid.values()) and len(gt_list) == EXP_SCANS)
            want_keys = ["icp"] if mode == "scan_to_scan_kitti" else [
                "vfm_ransac", "vfm_ransac_icp", "vfm_teaser", "vfm_teaser_icp", "icp"]
            keys_ok = list(node.rot_errors) == want_keys
            gt_errs = [compute_errors(p, t) for p, t in zip(gt_list, kitti_true if mode == "scan_to_scan_kitti"
                                                             else true_poses)]
            gt_ok = all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for rte, rre in gt_errs)
            out = {"phase": f"node_experiments_{mode}", "seconds": seconds, "scans": EXP_SCANS,
                   "stage_seconds": node.stage_seconds, "launches": launches,
                   "serial_vfm_searches": node.vfm_searches, "icp_calls": len(calls), "icp_loops": loops,
                   "gt_rte_m": [e[0] for e in gt_errs], "gt_rre_deg": [e[1] for e in gt_errs],
                   "rte_m": dict(node.trans_errors), "rre_deg": dict(node.rot_errors),
                   "max_rigidity_error": rigid, "points_in_map": node.points_in_map}
            host = sum(v for k, v in node.stage_seconds.items()
                       if k in ("cluster_removal", "cluster_insertion", "scan_to_scan_map"))
            out["experiment_host_seconds"] = host
            out["registration_seconds"] = seconds - host - node.stage_seconds.get("accumulate_map", 0.0)
            extra_ok = True
            if mode == "removal":
                clusters = [int(c) for c in re.findall(r"Clusters: (\d+)", log.getvalue())]
                acc_map, removal_gt0, removal_node = maps[0], gt_list[0], node
                left = [exp_trees_left(m, centers) for m in removed_maps]
                with contextlib.redirect_stdout(io.StringIO()):
                    again = RegistrationNode(empty, device=dev, **methods, **kw)
                    draws = np.random.RandomState(42)
                    for _ in range(EXP_SCANS):
                        again._apply_cluster_removal(acc_map, draws)
                extra_ok = (len(clusters) == EXP_SCANS and min(clusters) >= EXP_TREES
                            and exp_trees_left(acc_map, centers) == EXP_TREES
                            and all(0 < k < EXP_TREES for k in left)
                            and node.points_in_map == again.points_in_map)
                out.update(clusters=clusters, trees_left=left, points_in_map_again=again.points_in_map,
                           map_points=int(acc_map.shape[0]))
            ok = launches_ok and rigid_ok and keys_ok and gt_ok and extra_ok
            out["ok"] = ok
            emit(out)
            if not ok:
                raise RuntimeError(f"node_experiments {mode}: launches {launches_ok} ({launches}, "
                                   f"{node.vfm_searches} searches, {loops}), rigid {rigid_ok} ({rigid}), keys "
                                   f"{keys_ok} ({list(node.rot_errors)}), GT {gt_ok} ({gt_errs}), removal "
                                   f"{extra_ok} ({out.get('clusters')}, {out.get('trees_left')}, "
                                   f"{node.points_in_map} vs {out.get('points_in_map_again')})")
    tmp.cleanup()

    # B1-B3 at the removal's serial shapes: scan 0 on its first removed map.
    check_serial_kernels("node_experiments", dev, peaks, rows, removal_node, removed_maps[0],
                         layout["scene_point_clouds"][0], removal_gt0)
    return dict(total)


def make_structured_cloud(rng, n=1200):
    """A box corner with a sphere: a floor, a wall and a unit sphere with
    5 mm noise (a copy of `tests/test_fpfh.py:9`, whose conftest imports
    JAX)."""
    import numpy as np

    m = n // 3
    floor = np.c_[rng.uniform(0, 4, (m, 2)), np.zeros((m, 1))]
    wall_a = np.c_[rng.uniform(0, 4, (m, 1)), np.zeros((m, 1)), rng.uniform(0, 4, (m, 1))]
    sphere = rng.normal(size=(m, 3))
    sphere = sphere / np.linalg.norm(sphere, axis=1, keepdims=True) + [2, 2, 1]
    pts = np.concatenate([floor, wall_a, sphere]).astype(np.float32)
    return pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)


def _pose_gap(a, b):
    """(translation m, rotation deg) between two poses."""
    import numpy as np

    chord = np.linalg.norm(np.asarray(a)[:3, :3] - np.asarray(b)[:3, :3])
    return (float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3])),
            float(np.rad2deg(2 * np.arcsin(min(chord / (2 * np.sqrt(2)), 1.0)))))


def _row_cosines(a, b):
    """Per-row cosine; two zero rows (a point with no neighbour) count as 1."""
    import numpy as np

    na, nb = np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)
    both_zero = (na == 0) & (nb == 0)
    return np.where(both_zero, 1.0, (a * b).sum(1) / np.maximum(na * nb, 1e-30))


def compare_mutual_nn(dev, f0, f1, mutual, n_points):
    """`mutual_nn_correspondences` on the card against the CPU on the same
    descriptors f0 [N0, D], f1 [N1, D] (numpy): rows whose match or mask
    differ are counted as ties when the two choices are within
    MNN_TIE_RTOL of the mean squared norm of f1 (forward), or the row is
    within it of the best reverse match of its target (mutual), or of the
    n-th distance (top n); any other difference is a failure."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.ops.matching import mutual_nn_correspondences
    from vfmreg_tpu_torch.ops.voxel import bucket_size

    def pad(f):
        n = bucket_size(f.shape[0])
        out = torch.zeros((n, f.shape[1]), dtype=torch.float32)
        out[: f.shape[0]] = torch.from_numpy(f.astype(np.float32))
        return out, torch.arange(n) < f.shape[0]

    (F0, m0), (F1, m1) = pad(f0), pad(f1)
    card = mutual_nn_correspondences(F0.to(dev), m0.to(dev), F1.to(dev), m1.to(dev), mutual_filter=mutual,
                                     n_points=n_points)
    cpu = mutual_nn_correspondences(F0, m0, F1, m1, mutual_filter=mutual, n_points=n_points)
    n0 = f0.shape[0]
    a_idx, a_mask = card.idx1.cpu().numpy()[:n0], card.mask.cpu().numpy()[:n0]
    b_idx, b_mask = cpu.idx1.numpy()[:n0], cpu.mask.numpy()[:n0]
    g0, g1 = F0.numpy()[:n0].astype(np.float64), F1.numpy()[: f1.shape[0]].astype(np.float64)
    eps = MNN_TIE_RTOL * float(np.mean((g1 * g1).sum(1)))

    def d2(i, j):
        return float(((g0[i] - g1[j]) ** 2).sum())

    nth = None
    if not mutual:
        kept = np.sort(cpu.dist.numpy()[:n0][b_mask])
        nth = kept[-1] if kept.size else 0.0
    ties = bad = 0
    for i in np.flatnonzero((a_idx != b_idx) | (a_mask != b_mask)):
        tie = abs(d2(i, a_idx[i]) - d2(i, b_idx[i])) <= eps
        if mutual:
            for j in {int(a_idx[i]), int(b_idx[i])}:
                rev = ((g1[j] - g0) ** 2).sum(1)
                tie |= rev[i] - rev.min() <= eps
        else:
            tie |= abs(d2(i, a_idx[i]) - nth * nth) <= eps
        ties += int(tie)
        bad += int(not tie)
    return {"mutual": mutual, "rows": n0, "kept_card": int(a_mask.sum()), "kept_cpu": int(b_mask.sum()),
            "differing_rows": ties + bad, "ties": ties, "non_ties": bad, "ok": bool(bad == 0)}, (a_idx, a_mask)


def drive_node_baselines(dev, peaks, rows, scene, local_map, true_poses):
    """The node_baselines phase: the baseline descriptors and PointDSC.

    1. The four golden state dicts (`tests/golden/{dip,gedi,spinnet,
       pointdsc}_reference_golden.npz`, the reference torch modules' own
       layouts) are written to .pt files named by VFMREG_{DIP,GEDI,SPINNET,
       POINTDSC}_WEIGHTS, so every model below loads as a user's does, at
       the reference's full widths; each, fed the golden's inputs on the
       card, reproduces the golden's outputs (GOLDEN_ATOL).
    2. FPFH + mutual NN + RANSAC recovers the structured corner's transform
       within the reference test's 0.7 m (`tests/test_fpfh.py:74-108`).
    3. `RegistrationNode.run_scene` on the node phase's scene, batched, with
       the reference's full default matrix: RANSAC + ICP over fpfh, dip,
       gedi, fcgf, gcl, spinnet, vfm; TEASER + ICP over fpfh, vfm; PointDSC
       + ICP over fpfh, fcgf (FCGF and GCL with seeded weights written to
       .pt files named by VFMREG_{FCGF,GCL}_WEIGHTS), and `dump_viz_dir`
       set. Every pose finite and rigid, the error tables holding every key
       the reference's make_step writes, GT ICP against the true poses and
       the vfm rows against GT ICP (the recall gate), B2 and B3 launched as
       the ICP loops count, every file of the visualization dump parsed
       (the vertices and edges its header counts); the baselines' recall
       and seconds per method and stage reported, not gated (random
       weights).
    4. The card against the port's CPU evaluation on the first scan, with
       the same weights and draws: every extractor's points equal; FPFH
       rows within cosine FPFH_ROW_COS on FPFH_ROW_SHARE of them and a
       median of FPFH_MEDIAN_COS; DIP (the scan within CROP_M of its
       origin), GeDi (GEDI_POINTS of those within GEDI_CROP_M) and SpinNet
       (SPIN_KEYPOINTS) descriptors within cosine DESC_COS per row where
       the LRF is well conditioned (at least 4 neighbours; the others
       counted); mutual NN in both modes the same pairs apart from ties;
       the FPFH TEASER and PointDSC poses from those pairs, and PointDSC's
       on a known motion, within BASELINE_POSE_M / BASELINE_POSE_DEG;
       PointDSC's encoder on the FPFH pairs within PDSC_ATOL; FCGF and GCL
       descriptors within cosine DESC_COS per row and RESUNET_ATOL per
       entry, the points equal. Then
       GCL's block2_tr.conv1 on the map's 0.3 m voxels, card against CPU
       (`check_sparse_conv_level`).
    5. B2 and B3 at the fpfh RANSAC refine's start (scan 0, one lane)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from vfmreg_tpu_torch.descriptors import dip as ddip
    from vfmreg_tpu_torch.descriptors import fcgf as dfcgf
    from vfmreg_tpu_torch.descriptors import gcl as dgcl
    from vfmreg_tpu_torch.descriptors import gedi as dgedi
    from vfmreg_tpu_torch.descriptors import spinnet as dspin
    from vfmreg_tpu_torch.descriptors.fpfh import extract_fpfh_features
    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.kiss import get_voxel_hash_map, voxel_down_sample
    from vfmreg_tpu_torch.models import dip as mdip
    from vfmreg_tpu_torch.models import gedi as mgedi
    from vfmreg_tpu_torch.models import pointdsc as mpd
    from vfmreg_tpu_torch.models import sparse_resunet as mres
    from vfmreg_tpu_torch.models import spinnet as mspin
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.ops.matching import mutual_nn_correspondences
    from vfmreg_tpu_torch.ops.voxel import bucket_size
    from vfmreg_tpu_torch.pipeline.registration_node import RegistrationNode
    from vfmreg_tpu_torch.pipeline.synthetic import scene_file_layout
    from vfmreg_tpu_torch.registration import icp
    from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ, champion_group
    from vfmreg_tpu_torch.registration.ransac import ransac_registration
    from vfmreg_tpu_torch.registration.teaser import teaser_registration_exact

    weights = tempfile.TemporaryDirectory()
    golden = {}
    t0 = time.perf_counter()
    for name in ("dip", "gedi", "spinnet", "pointdsc"):
        data = np.load(os.path.join(ROOT, "tests", "golden", f"{name}_reference_golden.npz"))
        path = os.path.join(weights.name, f"{name}.pt")
        torch.save({k[4:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("sd::")}, path)
        os.environ[f"VFMREG_{name.upper()}_WEIGHTS"] = path
        golden[name] = {k: data[k] for k in data.files if not k.startswith("sd::")}
    for name, cfg in (("fcgf", mres.FCGF_CONFIG), ("gcl", mres.GCL_CONFIG)):
        net = mres.init_resunet_params(torch.Generator().manual_seed(SEED), cfg, device="cpu")
        path = os.path.join(weights.name, f"{name}.pt")
        torch.save({"state_dict": net.state_dict()}, path)  # a MinkowskiEngine checkpoint's nesting
        os.environ[f"VFMREG_{name.upper()}_WEIGHTS"] = path

    # 1. Goldens on the card, through the users' loaders.
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    errs = {}
    g = golden["dip"]
    errs["dip"] = float(np.abs(mdip.dip_forward(ddip.get_dip_net(dev), put(g["patches"].transpose(0, 2, 1)))
                               .cpu().numpy() - g["descriptors"]).max())
    g, net = golden["gedi"], dgedi.get_gedi_net(dev)
    p = put(g["patches"].transpose(0, 2, 1))
    with torch.no_grad():
        errs["gedi_quat"] = float(np.abs(net.qnet(p).cpu().numpy() - g["quat"]).max())
    errs["gedi"] = float(np.abs(mgedi.gedi_forward(net, p).cpu().numpy() - g["descriptors"]).max())
    g, net = golden["spinnet"], dspin.get_spinnet_net(dev)
    errs["spinnet_trunk"] = float(np.abs(mspin.spinnet_trunk(net, put(g["new_points"].transpose(0, 2, 3, 1)))
                                         .cpu().numpy() - g["trunk_out"]).max())
    errs["spinnet_var_to_invar"] = float(np.abs(mspin.var_to_invar(put(g["vpts"]), 9, 60, 30).cpu().numpy()
                                                - g["var_to_invar_out"]).max())
    g, model = golden["pointdsc"], mpd.get_pointdsc_model(dev)
    src, tgt = g["src"], g["tgt"]
    d_src = np.linalg.norm(src[:, None] - src[None], axis=-1)
    d_tgt = np.linalg.norm(tgt[:, None] - tgt[None], axis=-1)
    compat = np.clip(1.0 - (d_src - d_tgt) ** 2 / 1.2**2, 0.0, None).astype(np.float32)
    feat, conf = mpd.pointdsc_encode(model.net, put(g["corr_pos"]), put(compat))
    errs["pointdsc_encoder"] = float(np.abs(feat.cpu().numpy() - g["encoder_feat"]).max())
    errs["pointdsc_confidence"] = float(np.abs(conf.cpu().numpy() - g["confidence"]).max())
    n = src.shape[0]
    out = mpd.pointdsc_forward(model.net, put(g["corr_pos"]), put(src), put(tgt),
                               torch.ones(n, dtype=torch.bool, device=dev), ratio_num=int(n * 0.1))
    errs["pointdsc_final_trans"] = float(np.abs(out["final_trans"].cpu().numpy() - g["final_trans"]).max())
    labels_ok = bool(np.array_equal(out["final_labels"].cpu().numpy(), g["final_labels"].astype(bool)))
    golden_ok = labels_ok and all(v <= GOLDEN_ATOL[k] for k, v in errs.items())
    emit({"phase": "node_baselines_golden", "ok": golden_ok, "seconds": time.perf_counter() - t0,
          "max_abs_err": errs, "atol": GOLDEN_ATOL, "pointdsc_labels_equal": labels_ok})
    if not golden_ok:
        raise RuntimeError(f"golden activations on the card: {errs}, labels {labels_ok}")

    # 2. FPFH behaviour: the structured corner's transform.
    t0 = time.perf_counter()
    pts = make_structured_cloud(np.random.RandomState(42), n=1500)
    T = np.eye(4, dtype=np.float32)
    yaw = np.deg2rad(30.0)
    T[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
    T[:3, 3] = [1.0, -2.0, 0.3]
    corner_scan = (pts - T[:3, 3]) @ T[:3, :3]
    p_map, f_map = extract_fpfh_features(pts, 0.1, device=dev)
    p_scan, f_scan = extract_fpfh_features(corner_scan, 0.1, device=dev)

    def pad2048(x):
        out = torch.zeros((2048, x.shape[1]), dtype=torch.float32, device=dev)
        out[: x.shape[0]] = put(x.astype(np.float32))
        return out, torch.arange(2048, device=dev) < x.shape[0]

    fs, ms = pad2048(f_scan)
    fm, mm = pad2048(f_map)
    mnn = mutual_nn_correspondences(fs, ms, fm, mm, mutual_filter=True, chunk=512)
    ps, _ = pad2048(p_scan)
    pm, _ = pad2048(p_map)
    res = ransac_registration(ps[mnn.idx0], pm[mnn.idx1], mnn.mask,
                              torch.Generator(device=dev).manual_seed(0), num_hypotheses=2000)
    corner_err = float(np.linalg.norm(res.pose.cpu().numpy()[:3, 3] - T[:3, 3]))
    corner_ok = corner_err < CORNER_GATE_M
    emit({"phase": "node_baselines_fpfh_corner", "ok": corner_ok, "seconds": time.perf_counter() - t0,
          "translation_error_m": corner_err, "gate_m": CORNER_GATE_M, "correspondences": int(mnn.mask.sum())})
    if not corner_ok:
        raise RuntimeError(f"FPFH + mutual NN + RANSAC: translation error {corner_err} m")

    # 3. The scene loop with the baseline matrix.
    layout = scene_file_layout(scene, local_map)
    layout = dict(layout, scene_poses=layout["scene_poses"][:NODE_BASELINE_SCANS],
                  scene_point_clouds=layout["scene_point_clouds"][:NODE_BASELINE_SCANS])
    true_poses = true_poses[:NODE_BASELINE_SCANS]
    log = io.StringIO()
    viz = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as empty:
        with contextlib.redirect_stdout(log):
            node = RegistrationNode(empty, device=dev, dump_viz_dir=viz.name)
        poses, gts, maps = {}, {}, []
        score, accumulate = node.compute_errors, node._accumulate_map

        def recording(gt_pose, pose, method):
            gts.setdefault(node.scan_idx, np.array(gt_pose))
            poses.setdefault(method, []).append(np.array(pose))
            return score(gt_pose, pose, method)

        def keep_map(scn):
            maps.append(accumulate(scn))
            return maps[-1]

        node.compute_errors, node._accumulate_map = recording, keep_map
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log), icp.recording_loops() as calls:
            node.run_scene(layout)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    n_scans = len(layout["scene_poses"])
    expected = ([f"{m}_ransac{s}" for m in ("fpfh", "dip", "gedi", "fcgf", "gcl", "spinnet", "vfm")
                 for s in ("", "_icp")]
                + [f"{m}_teaser{s}" for m in ("fpfh", "vfm") for s in ("", "_icp")]
                + [f"{m}_pointdsc{s}" for m in ("fpfh", "fcgf") for s in ("", "_icp")] + ["icp"])
    keys_ok = sorted(node.rot_errors) == sorted(expected) and all(
        len(node.rot_errors[k]) == len(node.trans_errors[k]) == n_scans for k in expected)
    rigid = {k: max(float(np.abs(p[:3, :3].T @ p[:3, :3] - np.eye(3)).max()) for p in v) for k, v in poses.items()}
    finite = all(np.all(np.isfinite(p)) for v in poses.values() for p in v)
    rigid_ok = finite and all(v < RIGID_ATOL for v in rigid.values())
    gt_errs = [compute_errors(gts[i], t) for i, t in enumerate(true_poses)]
    gated = {m: list(zip(node.trans_errors[m], node.rot_errors[m])) for m in ("vfm_ransac_icp", "vfm_teaser_icp")}
    recall_ok = (len(gt_errs) == n_scans and all(a < RTE_GATE_M and b < RRE_GATE_DEG for a, b in gt_errs)
                 and all(all(a < RTE_GATE_M and b < RRE_GATE_DEG for a, b in v) for v in gated.values()))
    loop = collections.Counter()
    for c in calls:
        loop.update(c["loop"])
    loops = loop_check(loop, [i for c in calls for i in c["iterations"]], [k for c in calls for k in c["rebuilds"]],
                       GN_STEPS_PER_READ, sum(max(c["iterations"]) for c in calls))
    launches_ok = (launches.get("cosine_argmax", 0) >= node.vfm_searches + 1
                   and launches.get("gn_moments_from_cache", 0) == loop["step_calls"] > 0
                   and launches.get("champions_from_planes", 0) == loop["rebuild_rounds"] > 0 and loops["ok"])
    by_method = {}
    for k, v in node.stage_seconds.items():
        for col in ("_ransac_", "_teaser_", "_pointdsc_"):
            if col in k:
                head, part = k.split(col, 1)
                by_method.setdefault(head + col.rstrip("_"), {})[part] = v
    viz_files = check_viz_dump(viz.name, n_scans)
    viz.cleanup()
    ok = keys_ok and rigid_ok and recall_ok and launches_ok and viz_files["ok"]
    emit({"phase": "node_baselines", "ok": ok, "seconds": seconds, "scans": n_scans, "keys_ok": keys_ok,
          "max_rigidity_error": rigid, "rigid_ok": rigid_ok,
          "gt_rte_m": [e[0] for e in gt_errs], "gt_rre_deg": [e[1] for e in gt_errs],
          "recall": {m: [node.compute_success_rate(m, *t) for t in ((0.3, 15), (0.6, 1.5), (2, 5))]
                     for m in node.rot_errors},
          "seconds_by_method": by_method, "stage_seconds": node.stage_seconds,
          "batched_row_seconds": node.batched_stats["seconds"] if node.batched_stats else None, "launches": launches,
          "serial_vfm_searches": node.vfm_searches, "icp_calls": len(calls), "icp_loops": loops,
          "viz_dump": viz_files, "summary": log.getvalue().splitlines()[-32:]})
    if not ok:
        raise RuntimeError(f"node_baselines: keys {keys_ok} ({sorted(node.rot_errors)}), rigid {rigid_ok} ({rigid}), "
                           f"recall {recall_ok} ({gt_errs}, {gated}), launches {launches_ok} ({launches}, {loops}), "
                           f"viz {viz_files}")

    # 4. The card against the CPU on the first scan.
    t0 = time.perf_counter()
    scan0 = voxel_down_sample(layout["scene_point_clouds"][0], 0.1)[:, :3].astype(np.float32)
    crop = scan0[np.linalg.norm(scan0[:, :2], axis=1) < CROP_M]
    cmp = {}

    def both(fn, *a, **kw):
        return fn(*a, device=dev, **kw), fn(*a, device="cpu", **kw)

    (pc, fc), (pp, fp) = both(extract_fpfh_features, scan0, 0.1)
    cos = _row_cosines(fc, fp)
    cmp["fpfh"] = {"points_equal": bool(np.array_equal(pc, pp)), "rows": int(len(fc)),
                   "share_within_1e-3": float((np.abs(fc - fp).max(1) < 1e-3).mean()),
                   "share_cos_above": float((cos >= FPFH_ROW_COS).mean()), "median_cos": float(np.median(cos)),
                   "min_cos": float(cos.min()), "max_abs_err": float(np.abs(fc - fp).max())}
    cmp["fpfh"]["ok"] = bool(cmp["fpfh"]["points_equal"] and cmp["fpfh"]["share_cos_above"] >= FPFH_ROW_SHARE
                             and cmp["fpfh"]["median_cos"] >= FPFH_MEDIAN_COS)

    def learned(name, fn, pts, *a, atol=None, **kw):
        (pc_, fc_), (pp_, fp_) = both(fn, pts, *a, **kw)
        c = _row_cosines(fc_, fp_)
        # Neighbours within the LRF radius (DIP's kernel, GeDi's 0.5 m).
        radius = {"dip": mdip.LRF_KERNEL, "gedi": mgedi.R_LRF}.get(name)
        if radius is not None:
            d = np.linalg.norm(pc_[:, None, :] - pc_[None, :, :], axis=-1)
            good = (d <= radius).sum(1) >= 4
        else:
            good = np.ones(len(c), bool)
        r = {"points_equal": bool(np.array_equal(pc_, pp_)), "rows": int(len(c)), "well_conditioned": int(good.sum()),
             "min_cos_well_conditioned": float(c[good].min()) if good.any() else None,
             "below_cos_elsewhere": int((c[~good] < DESC_COS).sum()), "max_abs_err": float(np.abs(fc_ - fp_).max())}
        r["ok"] = bool(r["points_equal"] and good.any() and c[good].min() >= DESC_COS)
        if atol is not None:
            r["atol"] = atol
            r["ok"] = r["ok"] and r["max_abs_err"] <= atol
        return r

    cmp["dip"] = learned("dip", ddip.extract_dip_features, crop, 0.1)
    cmp["gedi"] = learned("gedi", dgedi.extract_gedi_features,
                          scan0[np.linalg.norm(scan0[:, :2], axis=1) < GEDI_CROP_M], 0.1, n_points=GEDI_POINTS)
    cmp["spinnet"] = learned("spinnet", dspin.extract_spinnet_features, scan0, SPIN_KEYPOINTS)
    cmp["fcgf"] = learned("fcgf", dfcgf.extract_fcgf_features, scan0, 0.3, atol=RESUNET_ATOL)
    cmp["gcl"] = learned("gcl", dgcl.extract_gcl_features, scan0, 0.3, atol=RESUNET_ATOL)

    down_map, feats_map = node.map_descriptor_cache["fpfh"]
    near = np.linalg.norm(down_map[:, :2] - gts[0][:2, 3], axis=1) < MAP_CROP_M
    mnn_rep, picks = {}, {}
    for mutual in (True, False):
        mnn_rep[mutual], picks[mutual] = compare_mutual_nn(dev, fc, feats_map[near], mutual, 5000)
    cmp["mutual_nn"] = [mnn_rep[True], mnn_rep[False]]
    dm = down_map[near]
    idx, keep = picks[True]
    s_pts, t_pts = pc[keep], dm[idx[keep]]
    n = len(s_pts)
    mask = np.ones(n, bool)
    te_card = teaser_registration_exact(s_pts, t_pts, mask, noise_bound=0.2, device=dev).pose.cpu().numpy()
    te_cpu = teaser_registration_exact(s_pts, t_pts, mask, noise_bound=0.2, device="cpu").pose.numpy()
    idx, keep = picks[False]
    pd_src, pd_tgt = pc[keep], dm[idx[keep]]
    models = {d: mpd.get_pointdsc_model(d) for d in (dev, "cpu")}
    pd = {d: m.register(pd_src, pd_tgt) for d, m in models.items()}
    # The encoder on those pairs (continuous), and the pose on a well-posed
    # set: scan 0's first 3,000 points under a known motion, 30 % outliers.
    corr = np.c_[pd_src, pd_tgt].astype(np.float32)
    corr -= corr.mean(0)
    dist = [np.linalg.norm(x[:, None] - x[None], axis=-1) for x in (pd_src, pd_tgt)]
    compat = np.clip(1.0 - (dist[0] - dist[1]) ** 2 / 1.2**2, 0.0, None).astype(np.float32)
    enc = {d: [t.cpu().numpy() for t in mpd.pointdsc_encode(m.net, torch.from_numpy(corr).to(d),
                                                              torch.from_numpy(compat).to(d))]
           for d, m in models.items()}
    del dist, compat
    rng = np.random.RandomState(0)
    motion = np.eye(4)
    motion[:3, :3] = [[np.cos(0.5), -np.sin(0.5), 0], [np.sin(0.5), np.cos(0.5), 0], [0, 0, 1]]
    motion[:3, 3] = [3.0, -2.0, 0.5]
    src_w = scan0[:3000].astype(np.float64)
    tgt_w = src_w @ motion[:3, :3].T + motion[:3, 3] + rng.normal(0, 0.005, src_w.shape)
    out_rows = rng.choice(len(src_w), len(src_w) * 3 // 10, replace=False)
    tgt_w[out_rows] = rng.uniform(tgt_w.min(0), tgt_w.max(0), (len(out_rows), 3))
    wp = {d: m.register(src_w, tgt_w) for d, m in models.items()}
    cmp["pointdsc_fpfh_encoder"] = {
        "max_abs_err_feat": float(np.abs(enc[dev][0] - enc["cpu"][0]).max()),
        "max_abs_err_confidence": float(np.abs(enc[dev][1] - enc["cpu"][1]).max()),
        "pairs": int(len(pd_src))}
    cmp["pointdsc_fpfh_encoder"]["ok"] = bool(cmp["pointdsc_fpfh_encoder"]["max_abs_err_confidence"] <= PDSC_ATOL
                                              and cmp["pointdsc_fpfh_encoder"]["max_abs_err_feat"] <= PDSC_ATOL)
    for name, (a, b) in (("teaser_fpfh", (te_card, te_cpu)), ("pointdsc_fpfh", (pd[dev], pd["cpu"])),
                         ("pointdsc_known_motion", (wp[dev], wp["cpu"]))):
        gap = _pose_gap(a, b)
        cmp[name] = {"translation_gap_m": gap[0], "rotation_gap_deg": gap[1],
                     "ok": bool(gap[0] <= BASELINE_POSE_M and gap[1] <= BASELINE_POSE_DEG)}
    cmp["pointdsc_known_motion"]["error_to_motion_m_deg"] = _pose_gap(wp[dev], motion)
    cpu_ok = bool(all(v["ok"] for k, v in cmp.items() if k != "mutual_nn")
                  and all(r["ok"] for r in cmp["mutual_nn"]))
    emit({"phase": "node_baselines_vs_cpu", "ok": cpu_ok, "seconds": time.perf_counter() - t0,
          "scan_points": int(scan0.shape[0]), "crop_points": int(crop.shape[0]), "map_crop_points": int(near.sum()),
          "compare": cmp, "bounds": {"fpfh_row_cos": FPFH_ROW_COS, "fpfh_row_share": FPFH_ROW_SHARE,
                                     "fpfh_median_cos": FPFH_MEDIAN_COS, "desc_cos": DESC_COS, "resunet_atol": RESUNET_ATOL,
                                     "pointdsc_atol": PDSC_ATOL,
                                     "mnn_tie_rtol": MNN_TIE_RTOL, "pose_m": BASELINE_POSE_M,
                                     "pose_deg": BASELINE_POSE_DEG}})
    if not cpu_ok:
        raise RuntimeError(f"node_baselines: the card against the CPU: {cmp}")
    check_sparse_conv_level(dev, maps[0][:, :3])

    # 5. B2 and B3 at the fpfh RANSAC refine's start: scan 0, one lane.
    with contextlib.redirect_stdout(io.StringIO()):
        vmap = get_voxel_hash_map(node.config, device=dev)
    vmap.add_points(np.ascontiguousarray(maps[0][:, :3]))
    grid = vmap.device_grid()
    dv = node._voxelize_scan(scan0)
    start = poses["fpfh_ransac"][0]
    w = bucket_size(dv.shape[0])
    src = torch.zeros((1, w, 3), device=dev)
    src[0, : dv.shape[0]] = put((dv[:, :3] @ start[:3, :3].T + start[:3, 3]).astype(np.float32))
    lane_mask = (torch.arange(w, device=dev) < dv.shape[0])[None]
    group = champion_group(grid)
    planes, caches = lane_planes(grid, src, lane_mask, group)
    rows["champions_from_planes"], champs = check_champions_lanes("node_baselines", planes, src, lane_mask, group,
                                                                  caches, peaks)
    sigma = node.config.adaptive_threshold.initial_threshold
    rows["gn_moments_from_cache"] = check_gn_lanes("node_baselines", champs, src, lane_mask, sigma / 3, 3 * sigma,
                                                   peaks)
    del planes, caches, champs, grid
    weights.cleanup()
    for name in ("dip", "gedi", "spinnet", "pointdsc", "fcgf", "gcl"):
        os.environ.pop(f"VFMREG_{name.upper()}_WEIGHTS", None)
    return launches


def parse_ply(path):
    """(vertices, edges) of an ASCII PLY the visualization dump writes; the
    body must hold exactly the rows its header counts, every vertex finite."""
    import numpy as np

    with open(path) as f:
        n_v = n_e = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element edge"):
                n_e = int(line.split()[-1])
            elif line == "end_header":
                break
        body = [ln.split() for ln in f]
    if len(body) != n_v + n_e:
        raise RuntimeError(f"{path}: {len(body)} rows, the header counts {n_v} + {n_e}")
    verts = np.asarray([[float(x) for x in r[:3]] for r in body[:n_v]]).reshape(-1, 3)
    if not np.isfinite(verts).all() or any(len(r) != 6 for r in body[:n_v]) or any(len(r) != 2 for r in body[n_v:]):
        raise RuntimeError(f"{path}: a malformed row")
    return n_v, n_e


def check_viz_dump(root, n_scans):
    """Every file of `--dump-viz`'s scene 0 parsed: the map, and per scan
    the scan at GT, at the flagship estimate (vfm RANSAC + ICP) and the
    correspondence segments (2 vertices an edge)."""
    scene = os.path.join(root, "scene_000")
    names = sorted(os.listdir(scene))
    want = sorted(["map.ply"] + [f"scan_{i:02d}_{k}.ply" for i in range(n_scans)
                                 for k in ("gt", "est_vfm_ransac_icp", "correspondences")])
    counts = {n: parse_ply(os.path.join(scene, n)) for n in names}
    ok = names == want and all(v > 0 for v, _ in counts.values()) and all(
        (e > 0 and v == 2 * e) if "correspondences" in n else e == 0 for n, (v, e) in counts.items())
    return {"ok": bool(ok), "files": {n: {"vertices": v, "edges": e} for n, (v, e) in counts.items()}}


def check_sparse_conv_level(dev, map_points):
    """One level of the sparse convolution at full width on the card against
    the CPU: GCL's block2_tr.conv1 (level 0, 128 -> 128, 27 offsets) on the
    map's 0.3 m voxels with seeded inputs and weights. The kernel map (exact
    integer lookups) equal, the outputs within SPARSE_CONV_ATOL."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.descriptors.fcgf import sparse_quantize
    from vfmreg_tpu_torch.ops.sparse_conv import build_coord_lookup, kernel_map, kernel_offsets, sparse_conv_apply_map

    t0 = time.perf_counter()
    coords, _ = sparse_quantize(map_points, 0.3)
    n, c = coords.shape[0], 128
    gen = torch.Generator().manual_seed(SEED)
    feats = torch.randn((n, c), generator=gen)
    weights = torch.randn((27, c, c), generator=gen) * float(np.sqrt(2.0 / (27 * c)))

    def run(d):
        """(kernel map, output, seconds of the convolution) on device d."""
        cc = torch.from_numpy(coords).to(d)
        mask = torch.ones(n, dtype=torch.bool, device=d)
        rows = kernel_map(build_coord_lookup(cc, mask), mask, cc, mask, kernel_offsets(3, 1))
        f, w = feats.to(d), weights.to(d)
        if d.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = sparse_conv_apply_map(f, rows, mask, w)
        if d.type == "cuda":
            torch.cuda.synchronize()
        return rows.cpu().numpy(), res.cpu().numpy(), time.perf_counter() - t1

    (rows_card, out_card, card_s), (rows_cpu, out_cpu, cpu_s) = run(dev), run(torch.device("cpu"))
    rows_equal = bool(np.array_equal(rows_card, rows_cpu))
    err = float(np.abs(out_card - out_cpu).max())
    ok = rows_equal and err <= SPARSE_CONV_ATOL
    emit({"phase": "node_baselines_sparse_conv", "ok": ok, "seconds": time.perf_counter() - t0, "voxels": n,
          "channels": c, "offsets": 27, "present_neighbours": int((rows_cpu < n).sum()),
          "kernel_map_equal": rows_equal, "max_abs_err": err, "atol": SPARSE_CONV_ATOL,
          "card_conv_seconds": card_s, "cpu_conv_seconds": cpu_s, "max_abs_out": float(np.abs(out_cpu).max())})
    if not ok:
        raise RuntimeError(f"sparse convolution level, card against CPU: rows equal {rows_equal}, error {err}")


def drive_odometry(dev, peaks, rows):
    """The odometry phase: `KissICP` with the default config (the map
    resident on the card) over ODO_FRAMES frames of
    `pipeline.synthetic.SyntheticDrive`, counted and timed by stage
    (`profile_slice.run_odometry`); gated on every frame's pose against the
    truth, on the resident map's rows against the same poses replayed into a
    host-side map (bit for bit, at every ODO_CHECK_EVERY-th frame), and on
    B2 launches = step calls and B3 launches = rebuild rounds summed over the
    frames. Then B2 and B3 checked at the odometry's shapes (the last
    frame's source at its pose against the final map), then fresh
    free-running runs of the first ODO_IDLE_FRAMES frames
    (`profile_slice.odometry_wall`), their poses gated, and the device idle
    share of one. Returns (the run's launches, the drive)."""
    import numpy as np
    import torch

    from vfmreg_tpu_torch.config import load_config
    from vfmreg_tpu_torch.geometry.metrics import absolute_trajectory_error, compute_errors, seq_error
    from vfmreg_tpu_torch.kiss.kiss_icp import KissICP
    from vfmreg_tpu_torch.kiss.mapping import VoxelHashMap
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.ops.voxel import bucket_size
    from vfmreg_tpu_torch.pipeline.synthetic import SyntheticDrive
    from vfmreg_tpu_torch.profile_slice import odometry_stats, odometry_wall, profile_run, run_odometry
    from vfmreg_tpu_torch.registration import icp
    from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ, champion_group

    t0 = time.perf_counter()
    drive = SyntheticDrive(n_frames=ODO_FRAMES, n_points=ODO_POINTS, seed=SEED)
    config = load_config(None)
    emit({"phase": "odometry_data", "seconds": time.perf_counter() - t0, "world_points": int(drive.world.shape[0]),
          "frames": ODO_FRAMES, "points_per_frame": ODO_POINTS, "config": dataclasses.asdict(config)})

    kiss = KissICP(config, device=dev)
    if not kiss.local_map.device_resident:
        raise RuntimeError("odometry: the map is not resident on the card")
    snapshots, counts = {}, []

    def after_frame(i):
        counts.append(int(kiss.local_map.device_grid().valid.sum()))
        if (i + 1) % ODO_CHECK_EVERY == 0:
            snapshots[i] = kiss.local_map.point_cloud()

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with icp.recording_loops() as calls:
        frame_rows = run_odometry(kiss, drive, range(ODO_FRAMES), after_frame=after_frame)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    poses = kiss.poses
    errs = [compute_errors(p, t) for p, t in zip(poses, drive.gt_poses)]
    poses_ok = len(poses) == ODO_FRAMES and all(rte < ODO_RTE_GATE_M and rre < ODO_RRE_GATE_DEG
                                                for rte, rre in errs)
    loop = collections.Counter()
    for c in calls:
        loop.update(c["loop"])
    iterations = [i for c in calls for i in c["iterations"]]
    loops = loop_check(loop, iterations, [k for c in calls for k in c["rebuilds"]], GN_STEPS_PER_READ,
                       sum(iterations))
    launches_ok = (launches.get("gn_moments_from_cache", 0) == loop["step_calls"] > 0
                   and launches.get("champions_from_planes", 0) == loop["rebuild_rounds"] > 0
                   and not any(c["weighted"] for c in calls) and loops["ok"])

    # The same poses into a host-side map: the same rows in the same order.
    t1 = time.perf_counter()
    host = VoxelHashMap(config.mapping.voxel_size, config.data.max_range, config.mapping.max_points_per_voxel,
                        device=dev, device_resident=False)
    map_equal = {}
    for i, pose in enumerate(poses):
        down = kiss.voxelize(kiss.preprocess(drive[i]))[1]
        host.update(down, pose)
        if i in snapshots:
            map_equal[i + 1] = bool(np.array_equal(host.point_cloud(), snapshots[i]))
    replay_seconds = time.perf_counter() - t1
    map_ok = len(map_equal) == ODO_FRAMES // ODO_CHECK_EVERY and all(map_equal.values())
    ate_rot, ate_trans = absolute_trajectory_error(drive.gt_poses, poses)
    seq_t, seq_r = seq_error(list(drive.gt_poses), poses)
    stats = odometry_stats(frame_rows)
    ok = poses_ok and launches_ok and map_ok
    slowest = sorted(frame_rows, key=lambda r: -r["total"])[:5]
    emit({"phase": "odometry", "ok": ok, "seconds": seconds, "frames": ODO_FRAMES, "stages": stats,
          "frames_per_s": stats["frames_per_s"], "slowest_frames": slowest, "map_rows": {"first": counts[0], "max": max(counts),
                                                              "last": counts[-1], "every_20": counts[::20]},
          "max_rte_m": max(e[0] for e in errs), "max_rre_deg": max(e[1] for e in errs),
          "ate_m": ate_trans, "ate_rad": ate_rot, "seq_error_pct": seq_t, "seq_error_deg_per_m": seq_r,
          "launches": launches, "icp_loop": loops, "map_equal_host_at_frame": map_equal,
          "replay_seconds": replay_seconds, "nvidia_smi": nvidia_smi(),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not ok:
        bad = [(i, e) for i, e in enumerate(errs) if not (e[0] < ODO_RTE_GATE_M and e[1] < ODO_RRE_GATE_DEG)]
        raise RuntimeError(f"odometry: poses {poses_ok} (first bad {bad[:5]}), launches {launches_ok} "
                           f"({launches}, {loops}), map {map_equal}")

    # B3 and B2 at the odometry's shapes: the last frame's 1.5 v source at
    # its pose against the final map, one lane; the GN kernel's width and
    # gate are the last frame's.
    grid = kiss.local_map.device_grid()
    source = kiss.voxelize(kiss.preprocess(drive[ODO_FRAMES - 1]))[0][:, :3]
    w = bucket_size(source.shape[0])
    src = torch.zeros((1, w, 3), device=dev)
    pose = poses[-1]
    src[0, : source.shape[0]] = torch.from_numpy((source @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)).to(dev)
    mask = (torch.arange(w, device=dev) < source.shape[0])[None]
    group = champion_group(grid)
    planes, caches = lane_planes(grid, src, mask, group)
    rows["champions_from_planes"], champs = check_champions_lanes("odometry", planes, src, mask, group, caches,
                                                                  peaks)
    sigma = kiss.adaptive_threshold.get_threshold()
    rows["gn_moments_from_cache"] = check_gn_lanes("odometry", champs, src, mask, sigma / 3, 3 * sigma, peaks)
    rows["nn_argmin"] = check_nn_argmin("odometry", champs[0, 0], champs[1, 0], champs[2, 0], src[0], peaks)
    del planes, caches, champs, grid, kiss
    torch.cuda.empty_cache()

    # Free-running, as `OdometryPipeline` runs it: fresh runs of the first
    # frames (read beforehand) with one synchronize at the end, in turns with
    # the map's lagged point count and with a synchronize after every update
    # (what a count read at once after each merge would cost); then the idle
    # share of a free run, on the host clock and under the profiler.
    frames = [drive[i] for i in range(ODO_IDLE_FRAMES)]
    walls, free_poses = {"lagged_count": [], "synced_update": []}, []
    for _ in range(2):
        for key in walls:
            run_kiss = KissICP(config, device=dev)
            walls[key].append(odometry_wall(run_kiss, frames, sync_update=key == "synced_update"))
            free_poses.append(run_kiss.poses)
    free_errs = [compute_errors(p, t) for poses_ in free_poses for p, t in zip(poses_, drive.gt_poses)]
    free_ok = (all(len(p) == ODO_IDLE_FRAMES for p in free_poses)
               and all(rte < ODO_RTE_GATE_M and rre < ODO_RRE_GATE_DEG for rte, rre in free_errs))
    emit({"phase": "odometry_free", "ok": free_ok, "frames": ODO_IDLE_FRAMES, "seconds": walls,
          "frames_per_s": {k: [ODO_IDLE_FRAMES / w for w in v] for k, v in walls.items()},
          "poses_equal_staged_run": [bool(np.array_equal(np.stack(p), np.stack(poses[:ODO_IDLE_FRAMES])))
                                     for p in free_poses],
          "max_rte_m": max(e[0] for e in free_errs), "max_rre_deg": max(e[1] for e in free_errs),
          "nvidia_smi": nvidia_smi()})
    if not free_ok:
        raise RuntimeError(f"odometry_free: poses off the truth ({max(free_errs)})")
    prof = profile_run(lambda: odometry_wall(KissICP(config, device=dev), frames))
    emit({"phase": "odometry_idle", "frames": ODO_IDLE_FRAMES, **prof})
    return launches, drive


def drive_odometry_xd(dev):
    """The odometry_xd phase: `KissICP(use_descriptors=True)` over the
    drive's first ODO_XD_FRAMES frames with DIM descriptor columns (the
    reference odometry server's v2 mode: the XD path's cosine-weighted
    champions, plain PyTorch on the card as the reference computes them
    outside its kernels), gated on every frame's pose, on no launch of B2 or
    B3, and on every ICP loop being the weighted one."""
    import torch

    from vfmreg_tpu_torch.config import load_config
    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.kiss.kiss_icp import KissICP
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.pipeline.synthetic import SyntheticDrive
    from vfmreg_tpu_torch.profile_slice import odometry_stats, run_odometry
    from vfmreg_tpu_torch.registration import icp

    drive = SyntheticDrive(n_frames=ODO_XD_FRAMES, n_points=ODO_POINTS, d=DIM, seed=SEED)
    kiss = KissICP(load_config(None), device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with icp.recording_loops() as calls:
        frame_rows = run_odometry(kiss, drive, range(ODO_XD_FRAMES), use_descriptors=True)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    errs = [compute_errors(p, t) for p, t in zip(kiss.poses, drive.gt_poses)]
    poses_ok = len(kiss.poses) == ODO_XD_FRAMES and all(rte < ODO_RTE_GATE_M and rre < ODO_RRE_GATE_DEG
                                                         for rte, rre in errs)
    weighted_ok = (len(calls) == ODO_XD_FRAMES - 1 and all(c["weighted"] for c in calls)
                   and sum(launches.values()) == 0)
    grid = kiss.local_map.device_grid()
    stats = odometry_stats(frame_rows)
    emit({"phase": "odometry_xd", "ok": poses_ok and weighted_ok, "seconds": seconds, "frames": ODO_XD_FRAMES,
          "dim": DIM, "stages": stats, "frames_per_s": stats["frames_per_s"],
          "slowest_frames": sorted(frame_rows, key=lambda r: -r["total"])[:3],
          "map_rows": int(grid.valid.sum()), "map_descriptor_dim": int(grid.feats.shape[1]),
          "max_rte_m": max(e[0] for e in errs), "max_rre_deg": max(e[1] for e in errs),
          "launches": launches, "gn_iterations": [i for c in calls for i in c["iterations"]],
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not (poses_ok and weighted_ok):
        raise RuntimeError(f"odometry_xd: poses {poses_ok} ({errs}), weighted {weighted_ok} ({launches})")
    del kiss, grid
    torch.cuda.empty_cache()
    return launches


def drive_odometry_readers(dev, drive):
    """The odometry_readers phase: the first ODO_READER_FRAMES frames of the
    odometry phase's drive written in MulRan's layout (`Ouster/<ns>.bin`,
    x y z intensity f32; `global_pose.csv`: t and the base's 3 x 4 pose,
    the lidar's truth conjugated by the base-to-lidar calibration) and in
    Boreas's (`lidar/<n>.bin`, 6 f32 a point; `applanix/lidar_poses.csv`:
    t, x y z, velocities, roll pitch yaw, rates), each read through
    `dataset_factory` and run by `OdometryPipeline` with the default config
    on the card (its files written in a temporary directory). Gated on every
    frame read back equal to the f32 frame written, cast to float64; the two
    runs' poses bit for bit equal (the same points in the same order); every
    pose within the odometry's pose gate of the drive's truth; B2 launches =
    step calls and B3 launches = rebuild rounds in each run; and each
    reader's ground truth equal to the written poses after its documented
    transform (MulRan: T P0^-1 Pi T^-1 with T its base-to-lidar matrix,
    within READER_GT_ATOL; Boreas: C0^-1 Ci, Ci from its roll, pitch and
    yaw, stored in f32, within READER_GT_F32_ATOL)."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation

    from vfmreg_tpu_torch.geometry.metrics import compute_errors
    from vfmreg_tpu_torch.kiss.datasets import MulranDataset, dataset_factory
    from vfmreg_tpu_torch.kiss.pipeline import OdometryPipeline
    from vfmreg_tpu_torch.ops import _build
    from vfmreg_tpu_torch.registration import icp
    from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ

    t0 = time.perf_counter()
    n = ODO_READER_FRAMES
    frames = [drive[i] for i in range(n)]
    truth = drive.gt_poses[:n]
    rng = np.random.RandomState(SEED)
    T = MulranDataset.T_LIDAR_TO_BASE
    base = np.linalg.inv(T) @ truth @ T  # the base poses whose lidar poses are the truth
    stamps = 1566534558000000000 + 100_000_000 * np.arange(n)  # ns, 10 Hz
    ypr = Rotation.from_matrix(truth[:, :3, :3].transpose(0, 2, 1)).as_euler("ZYX")  # C = (Rz Ry Rx)^T
    applanix = np.zeros((n, 13))
    applanix[:, 0] = stamps * 1e-9
    applanix[:, 1:4] = truth[:, :3, 3]
    applanix[:, 7:10] = ypr[:, ::-1]
    with tempfile.TemporaryDirectory() as tmp:
        mulran, boreas = Path(tmp) / "mulran", Path(tmp) / "boreas"
        for d in (mulran / "Ouster", boreas / "lidar", boreas / "applanix"):
            d.mkdir(parents=True)
        for stamp, f in zip(stamps, frames):  # MulRan: x y z intensity; Boreas: 6 floats a point
            np.c_[f, rng.uniform(0, 1, (len(f), 1))].astype(np.float32).tofile(mulran / "Ouster" / f"{stamp}.bin")
            np.c_[f, rng.uniform(0, 1, (len(f), 3))].astype(np.float32).tofile(boreas / "lidar" / f"{stamp}.bin")
        np.savetxt(mulran / "global_pose.csv", np.c_[stamps, base[:, :3, :4].reshape(n, 12)], delimiter=",")
        np.savetxt(boreas / "applanix" / "lidar_poses.csv", applanix, delimiter=",",
                   header="GPSTime,x,y,z,vel_x,vel_y,vel_z,roll,pitch,heading,ang_vel_z,ang_vel_y,ang_vel_x")
        written = np.loadtxt(mulran / "global_pose.csv", delimiter=",")[:, 1:].reshape(n, 3, 4)
        P = np.tile(np.eye(4), (n, 1, 1))
        P[:, :3] = written
        want_gt = {"mulran": (T @ np.linalg.inv(P[0]) @ P @ np.linalg.inv(T), READER_GT_ATOL)}
        rows = np.loadtxt(boreas / "applanix" / "lidar_poses.csv", delimiter=",", skiprows=1)
        C = np.tile(np.eye(4), (n, 1, 1))
        C[:, :3, :3] = Rotation.from_euler("ZYX", rows[:, [9, 8, 7]]).as_matrix().transpose(0, 2, 1)
        C[:, :3, 3] = rows[:, 1:4]
        want_gt["boreas"] = (np.linalg.inv(C[0]) @ C, READER_GT_F32_ATOL)
        emit({"phase": "odometry_readers_data", "seconds": time.perf_counter() - t0, "frames": n,
              "points_per_frame": [int(f.shape[0]) for f in frames]})

        runs = {}
        for name, root in (("mulran", mulran), ("boreas", boreas)):
            t1 = time.perf_counter()
            ds = dataset_factory(name, root)
            read_ok = len(ds) == n and all(np.array_equal(ds[i][0], frames[i].astype(np.float64))
                                           for i in range(n))
            gt, atol = want_gt[name]
            gt_err = float(np.abs(np.asarray(ds.gt_poses, dtype=np.float64) - gt).max())
            read_s = time.perf_counter() - t1
            pipe = OdometryPipeline(ds, device=dev)
            pipe.config.out_dir = str(Path(tmp) / "results" / name)
            torch.cuda.synchronize()
            _build.reset_launches()
            t1 = time.perf_counter()
            with icp.recording_loops() as calls:
                results = pipe.run()
            seconds = time.perf_counter() - t1
            launches = dict(_build.LAUNCHES)
            loop = collections.Counter()
            for c in calls:
                loop.update(c["loop"])
            iterations = [i for c in calls for i in c["iterations"]]
            loops = loop_check(loop, iterations, [k for c in calls for k in c["rebuilds"]], GN_STEPS_PER_READ,
                               sum(iterations))
            launches_ok = (launches.get("gn_moments_from_cache", 0) == loop["step_calls"] > 0
                           and launches.get("champions_from_planes", 0) == loop["rebuild_rounds"] > 0
                           and loops["ok"])
            poses = np.stack(pipe.poses)
            errs = [compute_errors(p, t) for p, t in zip(poses, truth)]
            poses_ok = len(poses) == n and all(rte < ODO_RTE_GATE_M and rre < ODO_RRE_GATE_DEG
                                               for rte, rre in errs)
            files = sorted(p.name for p in Path(pipe.results_dir).iterdir())
            ok = read_ok and gt_err <= atol and launches_ok and poses_ok
            runs[name] = poses
            emit({"phase": "odometry_readers", "reader": name, "dataset": type(ds).__name__, "ok": ok,
                  "frames_read_equal": read_ok, "gt_max_abs_err": gt_err, "gt_atol": atol,
                  "read_seconds": read_s, "seconds": seconds, "seconds_per_frame": seconds / n,
                  "max_rte_m": max(e[0] for e in errs), "max_rre_deg": max(e[1] for e in errs),
                  "launches": launches, "icp_loop": loops, "results": results.items(), "files": files,
                  "nvidia_smi": nvidia_smi()})
            if not ok:
                raise RuntimeError(f"odometry_readers {name}: frames {read_ok}, gt {gt_err} > {atol}, "
                                   f"launches {launches_ok} ({launches}, {loops}), poses {poses_ok} ({errs})")
    same = bool(np.array_equal(runs["mulran"], runs["boreas"]))
    emit({"phase": "odometry_readers_equal", "ok": same, "poses_equal": same,
          "max_abs_diff": float(np.abs(runs["mulran"] - runs["boreas"]).max())})
    if not same:
        raise RuntimeError("odometry_readers: the MulRan and Boreas runs of the same frames gave other poses")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from vfmreg_tpu_torch.geometry.metrics import compute_errors
        from vfmreg_tpu_torch.ops import _build
        from vfmreg_tpu_torch.ops.hash_grid import build_hash_grid
        from vfmreg_tpu_torch.ops.matching import l2_normalize
        from vfmreg_tpu_torch.pipeline import registration_node  # noqa: F401
        from vfmreg_tpu_torch.ops.matching import get_vfm_correspondences_batched
        from vfmreg_tpu_torch.registration.icp import GN_STEPS_PER_READ, champion_group
        from vfmreg_tpu_torch.registration.vfm_icp import (
            VFM_STEPS_PER_READ, register_frame_vfm, register_frames_vfm_lanes,
        )
        from vfmreg_tpu_torch.scan_to_map import (
            KERNEL, MAP_VOXEL_SIZE, MAX_CORRESPONDENCE_DISTANCE, scan_to_map, shared_map_batch, vfm_queries,
        )
        from vfmreg_tpu_torch.utils.precision import full_precision
    except ImportError as e:
        print(f"chip_smoke: the vfmreg_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["PCIe"] if "PCIe" in name else PEAKS["SXM"]
    emit({"phase": "device", "nvidia_smi": smi, "name": name, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peak_bytes_per_s": peaks[0], "peak_f32_flops": peaks[1], "peak_tf32_flops": peaks[2]})

    t0 = time.perf_counter()
    _build.build(["cosine_argmax", "gn_moments", "champions_from_planes", "flash_attention", "nn_argmin"])
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    t0 = time.perf_counter()
    full_precision()
    scene = shared_map_batch(BATCH, N_MAP, N_SCAN, DIM, seed=SEED)
    mp, mf, sp, sf = (torch.from_numpy(a).to(dev) for a in scene[:4])
    torch.cuda.synchronize()
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "map": list(mp.shape), "map_feats": list(mf.shape), "scans": list(sp.shape)})

    def drive():
        res = scan_to_map(mp, mf, sp, sf, n_vfm=N_VFM, max_iterations=MAX_ITERATIONS, device=dev)
        torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    drive()
    emit({"phase": "warmup", "seconds": time.perf_counter() - t0})

    # Kernel inputs at the main path's shapes: the flattened batch of VFM
    # queries against the grid's descriptors (B1); lane 0's champion cache
    # at its initial position (B2).
    grid = build_hash_grid(mp, MAP_VOXEL_SIZE, feats=mf)
    sm = torch.ones(sp.shape[:2], dtype=torch.bool, device=dev)
    _, f5, m5 = vfm_queries(sp, sf, sm, N_VFM)
    qn = l2_normalize(f5.reshape(-1, DIM)).contiguous()
    dbn = l2_normalize(grid.feats).contiguous()
    rows = {"slice": {"cosine_argmax": check_cosine("slice", qn, dbn, grid.valid, m5.reshape(-1), peaks)}}
    del qn, dbn
    # B2 and B3: all B scans at their start, the lanes of the one phase-2
    # loop that serves the batch; the one-lane entries of both kernels (the
    # one-scan callers' B = 1 loop) on scan 0.
    src = sp.contiguous()
    group = champion_group(grid)
    planes, caches = lane_planes(grid, src, sm, group)
    rows["slice"]["champions_from_planes"], champs = check_champions_lanes(
        "slice", planes, src, sm, group, caches, peaks)
    check_champions("slice", tuple(planes[:, 0]), src[0], sm[0], group, caches[0], peaks)
    rows["slice"]["gn_moments_from_cache"] = check_gn_lanes(
        "slice", champs, src, sm, KERNEL, MAX_CORRESPONDENCE_DISTANCE, peaks)
    check_gn("slice", caches[0], src[0], src[0].mean(dim=0).tolist(), KERNEL, MAX_CORRESPONDENCE_DISTANCE, peaks)
    cache = (caches[0].cx, caches[0].cy, caches[0].cz)
    rows["slice"]["nn_argmin"] = check_nn_argmin("slice", *cache, src[0], peaks)
    rows["slice"]["nn_argmin_ragged"] = check_nn_argmin(
        "slice_ragged", *(c[:, :NN_RAGGED_N].contiguous() for c in cache), src[0, :NN_RAGGED_N].contiguous(),
        peaks)
    del grid, planes, caches, champs, cache
    torch.cuda.empty_cache()

    # The main path, counted and timed end to end (grid build included).
    _build.reset_launches()
    t0 = time.perf_counter()
    res = drive()
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    errs = [compute_errors(p.astype("float64"), t) for p, t in zip(res.poses, scene.true_poses)]
    phase2 = (res.iterations - res.vfm_iterations).tolist()
    rebuilds = int(res.rebuilds.sum())
    lanes_ok = all(rte < RTE_GATE_M and rre < RRE_GATE_DEG for rte, rre in errs)
    # One lane loop serves the batch: phase 2's rounds are at most the
    # largest phase-2 iteration count; phase 1 reads the lanes' done flags
    # once every VFM_STEPS_PER_READ steps.
    loop = loop_check(res.loop, phase2, res.rebuilds.tolist(), GN_STEPS_PER_READ, max(phase2))
    vfm_read_bound = -(-int(res.vfm_iterations.max()) // VFM_STEPS_PER_READ) + 1
    reads_ok = (res.loop["vfm_reads"] <= vfm_read_bound
                and res.loop["vfm_steps"] == VFM_STEPS_PER_READ * res.loop["vfm_reads"])
    launches_ok = (launches.get("cosine_argmax", 0) >= 1
                   and launches.get("gn_moments_from_cache", 0) == loop["step_calls"]
                   and rebuilds > 0 and launches.get("champions_from_planes", 0) == loop["rebuild_rounds"]
                   and loop["ok"])
    # The batch against one-lane calls on the same grid and correspondences.
    grid = build_hash_grid(mp, MAP_VOXEL_SIZE, feats=mf)
    corrs = get_vfm_correspondences_batched(grid.points, grid.feats, grid.valid, *vfm_queries(sp, sf, sm, N_VFM))
    eye = torch.eye(4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = register_frames_vfm_lanes(grid, sp, sm, corrs, eye.expand(BATCH, 4, 4), MAX_CORRESPONDENCE_DISTANCE,
                                      KERNEL, max_iterations=MAX_ITERATIONS)
    torch.cuda.synchronize()
    lanes_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    ones = [register_frame_vfm(grid, sp[j], sm[j], corrs.lane(j), eye, MAX_CORRESPONDENCE_DISTANCE, KERNEL,
                               max_iterations=MAX_ITERATIONS) for j in range(BATCH)]
    torch.cuda.synchronize()
    one_lane_seconds = time.perf_counter() - t0
    one_lane_equal = all(
        torch.equal(batch.poses[j], o.pose) and torch.equal(batch.corr_mask[j], o.corr_mask)
        and torch.equal(batch.src_corr[j], o.src_corr)
        and (batch.vfm_iterations[j], batch.iterations[j], batch.rebuilds[j]) == (
            o.vfm_iterations, o.iterations, o.rebuilds)
        for j, o in enumerate(ones))
    same_as_main = bool(np.array_equal(batch.poses.numpy(), res.poses)
                        and np.array_equal(batch.iterations, res.iterations))
    del grid, corrs, batch, ones
    emit({"phase": "slice", "ok": lanes_ok and launches_ok and reads_ok and one_lane_equal, "seconds": seconds,
          "reg_per_s": BATCH / seconds, "batch": BATCH, "map_points": N_MAP, "scan_points": N_SCAN,
          "dim": DIM, "n_vfm": N_VFM, "max_iterations": MAX_ITERATIONS,
          "iterations": res.iterations.tolist(), "vfm_iterations": res.vfm_iterations.tolist(),
          "phase2_iterations": phase2, "rebuilds": rebuilds, "gn_steps_per_read": GN_STEPS_PER_READ,
          "vfm_steps": res.loop["vfm_steps"], "vfm_reads": res.loop["vfm_reads"],
          "vfm_steps_per_read": VFM_STEPS_PER_READ, "vfm_read_bound": vfm_read_bound, "vfm_reads_ok": reads_ok,
          "one_lane_bit_identical": one_lane_equal, "lanes_seconds": lanes_seconds,
          "one_lane_calls_seconds": one_lane_seconds, "lanes_equal_main_run": same_as_main,
          "icp_loop": loop, "n_correspondences": res.n_correspondences.tolist(),
          "rte_m": [e[0] for e in errs], "rre_deg": [e[1] for e in errs], "launches": launches,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not lanes_ok:
        raise RuntimeError(f"recall gate failed: {errs}")
    if not launches_ok:
        raise RuntimeError(f"the main path did not go through every kernel: {launches}, "
                           f"phase 2 = {phase2}, rebuilds = {rebuilds}, loop = {loop}")
    if not reads_ok:
        raise RuntimeError(f"VFM-ICP phase 1 read the device {res.loop['vfm_reads']} times "
                           f"({res.loop['vfm_steps']} steps; bound {vfm_read_bound})")
    if not one_lane_equal:
        raise RuntimeError("the VFM-ICP lanes differ from one-lane calls on the same inputs")
    del mp, mf, sp, sf, res
    torch.cuda.empty_cache()

    # The driver's method row, the scene loop around it, then the descriptor
    # pass, each counted on its own.
    rows["driver"] = {}
    by_path = {"slice": launches}
    by_path["driver"], driver_scene = drive_driver(dev, peaks, rows["driver"])
    torch.cuda.empty_cache()
    rows["node"] = {}
    by_path["node"] = drive_node(dev, peaks, rows["node"], *driver_scene)
    torch.cuda.empty_cache()
    rows["node_baselines"] = {}
    by_path["node_baselines"] = drive_node_baselines(dev, peaks, rows["node_baselines"], *driver_scene)
    torch.cuda.empty_cache()
    rows["node_experiments"] = {}
    by_path["node_experiments"] = drive_node_experiments(dev, peaks, rows["node_experiments"], *driver_scene)
    torch.cuda.empty_cache()
    by_path["node_sharded"] = drive_node_sharded(dev, peaks, rows, *driver_scene)
    for world in MERGED_WORLDS:  # no path launches B2 at these widths on one card
        by_path[f"node_sharded_k{32 * world}"] = {}
    del driver_scene
    torch.cuda.empty_cache()
    rows["odometry"] = {}
    by_path["odometry"], drive = drive_odometry(dev, peaks, rows["odometry"])
    drive_odometry_readers(dev, drive)
    del drive
    by_path["odometry_xd"] = drive_odometry_xd(dev)
    torch.cuda.empty_cache()
    rows["descriptor"] = {}
    by_path["descriptor"] = drive_descriptor(dev, peaks, rows["descriptor"])
    torch.cuda.empty_cache()
    rows["descriptor_vitg14"] = {}
    by_path["descriptor_vitg14"] = drive_descriptor_vitg14(dev, peaks, rows["descriptor_vitg14"])
    torch.cuda.empty_cache()
    rows["descriptor_maskclip"] = {}
    by_path["descriptor_maskclip"], mc_descs, mc_gen = drive_descriptor_maskclip(
        dev, peaks, rows["descriptor_maskclip"])
    drive_featup(dev)
    torch.cuda.empty_cache()
    drive_clip_text(dev, mc_gen, mc_descs[0])
    del mc_descs, mc_gen
    torch.cuda.empty_cache()
    rows["train"] = {}
    by_path["train"] = drive_train(dev, peaks, rows["train"])
    torch.cuda.empty_cache()

    # One row per kernel: the numbers of the newest path that checks it, and
    # under "paths" each path's numbers at its own shapes with its own launch
    # count.
    kernels = []
    for kname in ("cosine_argmax", "gn_moments_from_cache", "champions_from_planes", "nn_argmin",
                  "flash_attention"):
        per_path = {}
        for path, checked in rows.items():
            if kname in checked:
                per_path[path] = {k: checked[kname][k] for k in PATH_KEYS}
                per_path[path]["launches"] = by_path[path].get(kname, 0)
        newest = list(per_path)[-1]
        kernels.append({**rows[newest][kname], "launches": per_path[newest]["launches"],
                        "numbers_of_path": newest, "paths": per_path})
    # B4's times at every shape it was checked at, the two off-path shapes
    # (ragged n, K = 7) included.
    b4_keys = ("shape", "ms", "device_ms", "cold_ms", "cold_kernel_ms", "host_ms", "bound_ms")
    next(k for k in kernels if k["name"] == "nn_argmin")["shapes"] = [
        {"path": path, "check": key, **{k: r[k] for k in b4_keys}}
        for path, checked in rows.items() for key, r in checked.items() if key.startswith("nn_argmin")]
    emit({"phase": "script", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
