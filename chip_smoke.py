#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yoloclip_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and the repository checkout; imports no JAX.
Phases, each printing its results; any failure exits non-zero:

  1. device    -- the card's name and power limit (nvidia-smi);
  2. build     -- compile the three CUDA sources from yoloclip_tpu_torch/
                  csrc/ (one nvcc each, in parallel), ptxas's report, and
                  the count of tensor-core instructions in the SASS of each
                  similarity (HGMMA) and int8 conv (IGMMA) instantiation
                  (cuobjdump; none fails);
  3. kernel 1  -- folded similarity max/argmax vs its plain PyTorch version,
                  fp32 (TF32 off) and bf16, at batch 32: the main-path
                  shapes, C = 1 / 80 / 1203, A ragged against the row tiles
                  and A = 1, num_valid inside a class tile, text rows 7 and
                  700 copies of row 3 (across class tiles), a zero row;
  4. kernel 2  -- greedy NMS keep mask vs its plain version, bit for bit:
                  K = 1 / 33 / 1000 / 1024 / 2048 at batch 32, K = 8400 at
                  batch 2 and 16000 at batch 1, all, half, random, a prefix
                  or no candidate valid, random-valid runs right after
                  all-valid ones, copies and zero-area boxes, chains of 64
                  and 2000 boxes; and a 400,000-box chain (keeps every
                  other box);
  5. kernel 3  -- unprojected similarity max/argmax vs its plain version,
                  the same kinds of cases at E=512 (A = 8400, 400, 1),
                  normalize_obj both ways;
  5b. int8 conv -- the int8 conv (quantize -> s8 x s8 -> s32 -> dequant +
                  bias + SiLU) vs its plain version, fp32 and bf16 input:
                  the 22 int8 blocks of the deploy graph at bs=32, 640 px,
                  Cin = 80 (variant 'x') and 16, B = 1, a ragged 21 x 13
                  map, 1 x 1 maps, maps narrower and shorter than a tile at
                  both strides, Cout = 8 and 136, a 160 x 160 map,
                  operands all at +-127 and inputs on the rounding
                  boundaries; the int32 accumulator (epilogue off) bit for
                  bit, the fused output within INT8_TOL;
  6. text      -- the full-width CLIP text tower (12 x 512, seeded) on the
                  card vs the same weights on the CPU for 16 prompts; a
                  1203-class vocabulary build (6015 prompts) timed in fp32
                  and bf16 with its peak memory;
  7. main path -- YOLOCLIPDetector at variant 'n', 640x640, COCO-80 JSON
                  vocabulary, random weights from a seed: fp32 detect_batch
                  on 32 frames of 480x640 at conf 0.25 and -1.0, detect on
                  one frame, a bf16 detect_batch and an fp32 one at
                  conf -1.0 with nms_topk = 8400 (every anchor); kernel 1
                  (fp32 and bf16) and kernel 2 must have launched; outputs
                  finite;
                  a bs=2 fp32 run on the card against the same run on CPU;
  8. prompts   -- the LVIS-scale prompt path: YOLOCLIPDetector from 1203
                  class names (vocabulary built by the text tower on the
                  card), the unfolded scoring (model unfused + kernel 3 on
                  its obj_embeddings, fp32 and bf16) against the model's own
                  scores and the folded kernel-1 run, then detect_batch and
                  detect with five free-text prompts; every kernel must
                  launch;
  9. timing    -- detect_batch images/s (COCO-80 fp32 and bf16, LVIS-1203
                  fp32), the device time of each detect_batch stage alone
                  for those three (NMS also at conf -1.0 and at
                  nms_topk = 8400), kernels 1 (C = 80 and 1203) and 3
                  (C = 1203) through their wrappers and alone, and kernel 2
                  in NMS_SCENES with its mask build and scan apart, beside
                  their plain versions and bounds (CUDA events; kernel 2
                  alone and the NMS stage also by CUDA-graph replay);
 10. native    -- the native host library (built with the kernels, g++):
                  which backend the detector's host letterbox takes (must
                  be native), its canvas for 480x640, 720x1280 and
                  1080x1920 frames within 1 LSB of the numpy bilinear
                  resize, host ms per frame at each size, alone and from
                  8 threads;
 11. canvas    -- detect() at host_preprocess='auto' (the canvas path) on
                  the card against the CPU port on the same frame, fp32,
                  conf -1.0; kernels 1 and 2 must launch;
 12. server    -- DetectionServer, max_batch 32: 8 mixed-resolution
                  requests in fp32 at conf -1.0 against detect() on each
                  frame; then bf16 at conf 0.25: warmup() per bucket, 16
                  client threads over 512 mixed-resolution frames, closed
                  loop (each client waits for its answer) and open loop
                  (each submits all 32 first): requests/s, p50/p95
                  latency, occupancy, bucket, kernel launches;
 13. streaming -- StreamingDetector, 8 streams of 1080x1920 frames, 20
                  steps in bf16 (ms/step, fps/stream); one fp32 step at
                  conf -1.0 against detect_batch on the same frames;
 14. reparam   -- build_reparam_forward(..., nms=...) in fp32 at conf -1.0
                  against the detector's model and NMS on the same
                  canvases; img/s beside detect_batch's, fp32 and bf16;
 9b. int8      -- each int8 block at bs=32 through the wrapper beside its
                  plain version, its bound, im2col + torch._int_mm,
                  torch._int_mm alone on the prebuilt im2col operand and
                  cuDNN's bf16 conv; then quantize_int8 (8 seeded frames)
                  on fp32 and bf16 detectors at variant 'n', 640 px,
                  COCO-80: bf16 and fp32 detect_batch at bs=32 (22 int8
                  launches a forward), card vs CPU at bs=2 on the same
                  quantized state (every int8 block's input forced to the
                  card's; the free-running difference and its rounding
                  flips printed), img/s of float and int8 fp32 and bf16 in
                  turns, stage times, 8 server requests vs detect();
 9g. graphs    -- the per-shape programs (inference/program.py, CUDA
                  graphs) of the float fp32, float bf16 and int8 bf16
                  detectors at bs=32, 640 px, COCO-80: each detect_batch
                  program's replay against its eager body (ids, counts,
                  validity, saturation exact; scores and boxes within
                  GRAPH_ATOL), a result held across the next call
                  unchanged, the launches of GRAPH_CALLS replays equal to
                  that many eager calls', img/s in turns (eager, program,
                  program, eager), device ms a call and idle share from a
                  trace of each, the hand kernels' events in the trace of
                  the program calls equal to their counters' increments,
                  warm-up and capture seconds; then in
                  bf16 both detect() branches against their eager bodies,
                  the server's warmed buckets against an eager server (8
                  requests), two threads at once on the graph pool
                  (detect_batch and the 32-bucket, POOL_CALLS each, every
                  result against its eager body; requests/s and p50/p95 of 16 closed-loop
                  clients and the dispatch step of a batch of 32, in
                  turns), the streaming step against its eager step, a
                  body that calls .item() raising at capture, and the
                  graph pool's GiB;
 9e. int8 edges -- the int8-stored edges (YOLOCLIP_STORE_INT8_MIN_ELEMS;
                  the port's threshold set for the phase, restored
                  after): the int8 conv's int8-input mode vs its plain
                  version (the four edge readers at bs=32 in fp32 and
                  bf16 output, the 42 cases of 5b on quantized input;
                  accumulators bit for bit); then at thresholds 1 << 62,
                  819200 and 0 (0 / 1 / 9 stored edges) quantize_int8 and
                  fp32 and bf16 detect_batch at bs=32 (22 int8 launches a
                  forward, 0 / 0 / 4 with int8 input; kernels 1 and 2),
                  card vs CPU at bs=2 with 9b's forcing, img/s in turns,
                  backbone and neck device ms, the readers from int8
                  against float input;
 9c. stems     -- stem_s2d and stem_u8_s2d detectors against the plain
                  stem on the same weights and frames (the JAX package's
                  tolerances), and their detect_batch;
 9d. export   -- utils/export.py: the fp32, bf16 and int8 fp32 COCO-80
                  detectors exported at bs=32, 640 px with NMS (conf -1.0)
                  and saved; a fresh interpreter that imports only
                  utils/export.py loads and runs each on the letterboxed
                  frames: count, class ids and validity equal to the eager
                  model + batched_nms, boxes and scores within the bounds;
                  one call's launches (3 kernel-1, 1 kernel-2, 22 int8
                  convs in the int8 graph); a bs=2 160-px artifact traced
                  on the card, moved to the CPU, against the CPU eager path;
                  export seconds, bytes, img/s beside eager; the custom-op
                  dispatch A/B (bf16 float and int8 detect_batch);
 15. http, CLIs -- make_handler on a localhost ThreadingHTTPServer (POST
                  /detect with a stdlib-encoded PNG, POST /vocab, GET
                  /stats and /healthz), then `python -m
                  yoloclip_tpu_torch.cli.detect`, `cli.stream --streams 2
                  --steps 3` and `cli.warmup` (builds and loads the
                  libraries) as subprocesses, exit 0.
 15b. profile -- utils/profiling.py on 10 bf16 detect_batch calls at bs=32:
                  trace() writes a Chrome trace that must hold kernel 1 and
                  kernel 2 events, the device's idle share read from it,
                  the top kernels; the program's own spans, graph
                  stages and counters (`take`), the idle gaps by
                  program span; memory_stats();
 16. training  -- YOLOCLIPTrainer at variant 'n', 640 px, from seeded
                  weights on synthetic arrays (the card has no image
                  decoder): one compat fp32 AdamW step at bs=2 against the
                  same step in float64 on the CPU (loss parts, gradients,
                  BatchNorm buffers, parameters); at bs=16 with the 80
                  COCO prompts a sample, step ms, img/s and peak memory
                  for compat fp32, clean fp32 and clean bf16 (the
                  trainer's train programs); evaluate with NMS on 32
                  images (kernel 2); a torch.profiler breakdown of one
                  clean step (top 10 kernels, idle share); the overfit
                  twin of tests/test_convergence.py
                  (121 clean deterministic steps at 128 px, bs=4),
                  served from its checkpoint by YOLOCLIPDetector
                  (kernels 1 and 2): one
                  box per image, class 0, IoU >= 0.5; then cli.eval on
                  those images written as PNG files, where the machine
                  can decode them (it says so where it cannot).
16g. train graphs -- under deterministic algorithms, at bs=16, 640 px:
                  compat fp32, clean fp32 with grad_accum_steps=2 and EMA,
                  clean bf16, each 3 steps through the trainer's train
                  program and 3 through the eager body from one seeded
                  state, every state tensor and loss part bit-equal; the
                  eval program (NMS on) equal to its body, kernel 2 once a
                  replay; step ms in turns eager, program, program, eager,
                  device ms and idle share, peak GiB, capture s and the
                  top-10 breakdown of each; the text tower's encode
                  programs (the 1203-class vocabulary, 8 online prompts)
                  bit-equal to the eager tower, build ms in turns; the
                  graph pool; a grad program that syncs raises at capture.
16h. ckpt async -- the clean bf16 trainer with an EMA on its train program
                  at bs=16, 640 px: save(wait=True), then save(wait=False)
                  of the same state and at once one more step; the async
                  file equals the wait=True file tensor for tensor; each
                  save's stall of the step loop (ms) and the file's MiB;
 17. ddp       -- parallel/ on the one card: two ranks on cuda:0 through
                  gloo (NCCL refuses two ranks on one device) take a compat
                  fp32 and a clean bf16 step at global bs=16 (8 a rank),
                  held against the 1-process step on the card (loss parts,
                  gradients, BatchNorm buffers; parameters against AdamW on
                  the ranks' gradients; the ranks' parameters identical);
                  one NCCL rank against the step without DDP; evaluate
                  with NMS on 32 images under the two ranks (the same
                  metrics on both, kernel 2 in each) and
                  make_sharded_inference with the folded scoring on each
                  rank's rows (kernels 1 and 2 in each); all through the
                  eager DDP route: the program route over gloo on the
                  card must raise, and the trainer take the eager route;
 17b. ddp graphs -- the sharded train and eval steps as programs (CUDA
                  graphs holding NCCL's collectives), one NCCL rank on
                  cuda:0, under deterministic algorithms: compat fp32 with
                  EMA and clean bf16 at bs=16, 640 px, 3 steps through the
                  program and the eager DDP route, every state tensor
                  bit-equal; the eval program with NMS equal to the eager
                  eval step, kernel 2 once a replay; step ms in turns,
                  idle share, peak GiB, capture s, pool GiB; the bf16
                  program with its BatchNorms synced over the 1-rank
                  group (the several-card path's cost on one card). With
                  two cards or more: 2 NCCL ranks, the compat fp32 step
                  against the 1-process step with [ddp]'s bounds; on 2
                  and on all cards the clean bf16 step ms a rank at 16
                  rows a rank and rank 0's trace of one step;
 18. dp serve  -- a DetectionServer and a StreamingDetector over two
                  replicas on cuda:0, fp32 conf -1.0, against the
                  single-device canvas program / step on each replica's
                  share (equal); one `serve --devices cuda:0,cuda:0 --int8`
                  batch (the int8 kernel on both replicas).
 19. vocab tp  -- detect_batch at bs=32, fp32, with the 1203-class
                  vocabulary over an in-process 1x2 mesh (cuda:0 twice):
                  kernel 1 on each class block (one thread a shard),
                  merged, against the unsharded program (scores 1e-6, ids
                  outside near-ties, detections); each shard's kernel-1
                  launch, a block with num_valid 0 and kernel 3's sharded
                  scoring (C = 1203) against the plain versions; the int8
                  batch over the mesh against the single-device one (the
                  kernel's accumulators equal to plain on its inputs);
 20. spatial   -- detect() on one 640-px frame split 2 and 4 ways in
                  height (1x2 and 2x2 meshes of cuda:0) and detect_batch at
                  bs=32 on the 2x2 grid (batch over data x height over
                  model), fp32 and int8, against the unsplit programs
                  (JAX's bounds: scores 1e-4, boxes 1 px; int8
                  accumulators equal to plain on the halo-extended
                  inputs); the 1-, 2- and 4-way latencies;
 20b. split ranks -- the class-sharded forward and the spatial split with
                  one process a cell: two gloo ranks on cuda:0 as a 1x2
                  grid run make_sharded_inference (LVIS-1203 detect_batch
                  at bs=32) and spatialize_detector (640-px detect() split
                  2 ways) on their eager route, against the single-card
                  programs with [vocab tp]'s and [spatial]'s bounds; their
                  program route must raise (gloo cannot be captured).
                  With two cards or more, one NCCL rank a card on 1x2 and
                  1 x all grids: both as programs (CUDA graphs holding
                  NCCL's exchanges) against the eager route (ids exact,
                  scores and boxes within GRAPH_ATOL, bit-equality
                  printed) and the single-card programs, kernels 1 and 2
                  once a level / once a call, img/s and detect() ms
                  program and eager beside the single card's, capture s,
                  pool GiB; on four, detect_batch over a 2x2 grid (batch
                  over data x height over model);
 21. tp train  -- two gloo ranks on cuda:0 as a 1x2 (data x model) grid:
                  one compat fp32 class-sharded step at 640 px, bs=16,
                  against the 1-process step with [ddp]'s bounds;
 22. multihost -- the self-test (`parallel/multihost.py --selftest --model
                  2`) in 8 processes on cuda:0 (gloo) as a 4x2 grid, each
                  loss against the 1-process self-test.
Every detect_batch, detect(), server bucket and streaming step, the
trainer's train and eval steps (one device, and sharded over NCCL) and
the text tower's encode run as their programs, captured at the first call: the launch counters
count the first call's eager run and every replay, never the capture.
Each path that launches kernels (main path, prompts, int8, graphs, int8 edges,
stems, export, canvas, server, streaming, reparam, profile, training, train
graphs, the ddp ranks, ddp graphs, dp serve, vocab tp, spatial, split ranks) runs with the launch
counters set to 0 just before it and read just after;
the kernels line sums them. Two ranks or replicas on one card show
correctness, not scaling.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# cuBLAS repeats its results only with a workspace fixed before its first
# call; `[overfit]` trains under torch.use_deterministic_algorithms
os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')

# Kernels 1 and 3 against their plain versions: both sum fp32 products of
# the same fp32/bf16 inputs, in different orders; cosines are O(0.1-1).
SIM_ATOL = 1e-5
# Card (cuDNN, TF32 off) against CPU for the whole model: conv algorithms
# differ; random-init boxes reach 1e4 px through exp(wh).
XDEV_SCORE_ATOL = 1e-4
XDEV_BOX_RTOL, XDEV_BOX_ATOL = 1e-4, 1e-2
XDEV_TIE_GAP = 1e-4
# Text tower, card (TF32 off) against CPU, normalised embeddings: 12 layers
# of fp32 matmuls summed in different orders.
TEXT_ATOL = 1e-4

BATCH, LEVELS, HIDDEN, EMBED = 32, (6400, 1600, 400), 256, 512
ANCHORS = sum(LEVELS)
LVIS_C = 1203
LVIS_NAMES = [f'object {i}' for i in range(LVIS_C)]
PROMPTS = ['a photo of a cat', 'a dog', 'person', 'a red car',
           'traffic light', 'café au lait', '日本の猫', 'naïve résumé',
           'Ünïcödé zebra', "it's a dog's life!", 'e&#769;tude',
           'a photograph of a pizza', 'teddy bear', 'hair drier',
           'an image of a fire hydrant', '{}']
FREE_PROMPTS = ['a red car', 'a person on a bicycle', 'café', 'a dog',
                'traffic light']

# The H100 SXM's published dense peaks and memory rate. A kernel's bound is
# the larger of its operations over the peak of the units it runs on and
# its bytes (inputs read once, outputs written once) over HBM. Kernels 1
# and 3 run on the tensor cores: bf16 at the bf16 peak, fp32 as 3xTF32
# (three TF32 products for each fp32 one, at the TF32 peak). NMS runs in
# fp32 on the CUDA cores.
BF16_TC, TF32_TC, FP32_CORES = 989e12, 495e12, 67e12
HBM_BYTES_S = 3.35e12
# bf16 kernel 3 on the prompt path against the fp32 run on the same rows:
# rounding both operands to bf16 moves each product by <= 2^-8 relative.
BF16_PATH_ATOL = 1e-2
# Rows duplicated from row 3 of the text: the lower index must win, also
# across class tiles (128 classes a tile).
DUP_ROWS = (7, 700)
# Kernel 1 cases (A, C, num_valid) and kernel 3 cases (A, C, num_valid,
# normalize_obj), each run in fp32 and bf16 at batch 32: the main-path
# shapes, C = 1 / 80 / 1203, A ragged against the row tiles (400, 1600)
# and A = 1, num_valid inside a class tile.
K1_CASES = [(6400, 80, None), (1600, 80, None), (400, 80, None),
            (6400, 1203, None), (400, 1203, 1000), (1600, 80, 33),
            (1, 80, None), (1, 1, None), (400, 1, None)]
K3_CASES = [(8400, 80, None, True), (8400, 80, None, False),
            (8400, 1203, None, True), (8400, 1203, None, False),
            (8400, 1203, 1186, True), (400, 1203, 1000, True),
            (1, 80, None, False), (1, 1, None, True), (400, 1, None, True)]
# Kernel 2 timing scenes (B, K, valid prefix): all valid at the main path's
# K (the kernels line's scene, first), one image, a valid prefix of 128,
# none valid, and every anchor of a 640-px frame a candidate.
NMS_SCENES = [(BATCH, 1024, 1024), (1, 1024, 1024), (BATCH, 1024, 128),
              (BATCH, 1024, 0), (BATCH, ANCHORS, ANCHORS)]


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(flops: float, nbytes: float, peak: float):
    """(least time in ms, 'operations' or 'bytes')."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def sim_bound(flops: float, nbytes: float, dtype: torch.dtype):
    """Bound of kernel 1 or 3: bf16 at the bf16 tensor-core peak, fp32 as
    3xTF32 at the TF32 peak."""
    if dtype == torch.float32:
        return bound(3 * flops, nbytes, TF32_TC)
    return bound(flops, nbytes, BF16_TC)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms with the host out of the way:
    `iters` calls captured in one CUDA graph, one replay timed by CUDA
    events after a warm-up replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_device() -> str:
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    return line


def phase_build(_build) -> None:
    t = time.time()
    reports = _build.build_all()
    print(f'[build] {", ".join(f"{k}.cu" for k in _build.KERNELS)} built '
          f'from {_build.CSRC}, native/dataload.cpp from {_build.NATIVE}, '
          f'in {time.time() - t:.2f} s (parallel nvcc and g++)')
    print(f'[build] native/dataload.cpp: {reports.pop("native/dataload")}')
    for name, rep in reports.items():
        for ln in rep.splitlines():
            if 'registers' in ln or 'spill' in ln or 'Compiling entry' in ln:
                print(f'[build] {name}: {ln.strip()}')
    lib = _build.load('similarity')
    for sym in ('yc_similarity_f32', 'yc_similarity_bf16',
                'yc_similarity_unprojected_f32',
                'yc_similarity_unprojected_bf16'):
        require(hasattr(lib, sym), f'symbol {sym} missing')
    counts = _sass_gmma(_build.BUILD_DIR / 'libsimilarity.so')
    for fn, n in counts.items():
        kind = ('bf16' if '__nv_bfloat16' in fn else 'fp32') + (
            ' folded' if 'Lb1E' in fn else ' unprojected')
        print(f'[build] SASS of similarity_wgmma, {kind}: {n} HGMMA '
              f'(tensor-core) instructions')
    require(len(counts) == 4 and all(counts.values()),
            'a similarity instantiation has no tensor-core instruction')
    lib = _build.load('int8_conv')
    for sym in ('yc_int8_conv_f32', 'yc_int8_conv_bf16',
                'yc_int8_conv_s8_f32', 'yc_int8_conv_s8_bf16'):
        require(hasattr(lib, sym), f'symbol {sym} missing')
    counts = _sass_gmma(_build.BUILD_DIR / 'libint8_conv.so', 'IGMMA')
    for fn, n in counts.items():
        print(f'[build] SASS of int8_conv_wgmma {fn}: {n} IGMMA (int8 '
              f'wgmma) instructions')
    require(len(counts) == 8 and all(counts.values()),
            'an int8_conv instantiation (fp32, bf16 or int8 input, 128 or '
            '256 channels a block) has no int8 wgmma instruction')


def _sass_gmma(lib_path, op: str = 'HGMMA') -> dict:
    """`op` instructions (HGMMA, IGMMA) in each kernel of a built library
    (cuobjdump)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if 'Function :' in ln:
            fn = ln.split('Function :')[1].strip()
            counts[fn] = 0
        elif fn is not None and op in ln:
            counts[fn] += 1
    return counts


def _sim_inputs(g, A, C, dtype):
    """Kernel 1 inputs at batch 32: hidden rows in `dtype` with row
    (0, min(3, A-1)) zero, the head's K and bias, unit text (B, C, 512)
    whose rows DUP_ROWS copy row 3."""
    h = torch.randn(BATCH, A, HIDDEN, device='cuda', generator=g)
    h[0, min(3, A - 1)] = 0.0            # zero hidden row: norm = ||b||
    K = torch.randn(HIDDEN, EMBED, device='cuda', generator=g) / 16
    b = 0.1 * torch.randn(EMBED, device='cuda', generator=g)
    t = torch.randn(BATCH, C, EMBED, device='cuda', generator=g)
    t = t / t.norm(dim=-1, keepdim=True)
    for r in DUP_ROWS:
        if r < C:
            t[:, r] = t[:, 3]            # exact tie: class 3 must win
    return h.to(dtype), t, K, b


def _near_ties(raw, norm):
    """(B, A) bool: best and second-best raw score, over the norm, differ
    by less than SIM_ATOL."""
    if raw.shape[-1] < 2:
        return torch.zeros(raw.shape[:-1], dtype=torch.bool, device='cuda')
    top2 = raw.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) / norm < SIM_ATOL


def _require_ids(i, num_valid, C, tag):
    for r in DUP_ROWS:
        if r < C and (num_valid is None or r < num_valid):
            require(not (i == r).any().item(),
                    f'{tag}: duplicated class {r} beat class 3')
    if num_valid is not None:
        require(bool((i < num_valid).all()), f'{tag}: num_valid')


def phase_kernel1(sim):
    """Returns the worst score difference per input type."""
    g = torch.Generator(device='cuda').manual_seed(1)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype] = 0.0
        for A, C, nv in K1_CASES:
            h, t, K, b = _sim_inputs(g, A, C, dtype)
            s, i = sim.fused_projected_similarity_argmax(h, t, K, b, nv)
            ps, pi = sim.similarity_argmax_plain(h, t, K, b, nv)
            tp, cb = sim._fold_text(t, K, b, dtype)
            raw = torch.matmul(h.float(), tp.float().transpose(1, 2)) \
                + cb[:, None]
            if nv is not None:
                raw[..., nv:] = sim.NEG
            norm = (torch.matmul(h.float(), K.to(dtype).float()) + b).norm(
                dim=-1).clamp_min(1e-12)
            tie = _near_ties(raw, norm)
            del raw
            torch.cuda.synchronize()
            err = (s - ps).abs().max().item()
            bad = ((i != pi) & ~tie).sum().item()
            worst[dtype] = max(worst[dtype], err)
            tag = (f'{str(dtype)[6:]:8s} B={BATCH} A={A:5d} C={C:4d} '
                   f'num_valid={nv}')
            print(f'[kernel1] {tag}: max|score-plain|={err:.3e} (tol '
                  f'{SIM_ATOL:g}) id mismatches outside near-ties={bad} '
                  f'near-tie anchors exempt={int(tie.sum())}')
            require(err <= SIM_ATOL, f'kernel 1 scores disagree ({tag})')
            require(bad == 0, f'kernel 1 ids disagree ({tag})')
            _require_ids(i, nv, C, f'kernel 1 ({tag})')
            del h, t
    return worst


def _nms_scene(g, B, K):
    c = torch.rand(B, K, 2, device='cuda', generator=g) * 200
    half = K // 2
    c[:, half:] = c[:, :K - half] + torch.randn(
        B, K - half, 2, device='cuda', generator=g) * 12
    wh = 20 + torch.rand(B, K, 2, device='cuda', generator=g) * 60
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


def _chain(n, lead=0, tail=0):
    """`lead` lone boxes, a chain of n boxes each overlapping the next
    with IoU 1/3 (and the one after with 0), then `tail` lone boxes: at
    threshold 0.3 greedy keeps every other box of the chain."""
    x = 5.0 * torch.arange(n, device='cuda')
    link = torch.stack([x, 0 * x, x + 10, 0 * x + 10], -1)
    x = -1000.0 - 20 * torch.arange(lead + tail, device='cuda')
    lone = torch.stack([x, 0 * x, x + 10, 0 * x + 10], -1)
    return torch.cat([lone[:lead], link, lone[lead:]])


def _degenerate_scene(g, B, K):
    """An overlap scene with copies of a higher-ranked box, zero-width
    boxes and identical zero-area points."""
    boxes = _nms_scene(g, B, K)
    boxes[:, 10:20] = boxes[:, 5:6]                  # IoU ~1 with box 5
    boxes[:, 30:40, 2] = boxes[:, 30:40, 0]          # zero width
    boxes[:, 50:60] = torch.tensor([40.0, 40.0, 40.0, 40.0], device='cuda')
    return boxes


def phase_kernel2(nms) -> float:
    """The keep mask against its plain version, bit for bit: ragged K
    against the 32-candidate word and the 64-candidate tile, K above the
    old 1024 limit, valid prefixes and none, degenerate boxes, chains, and
    random-valid runs right after all-valid runs of the same shape (the
    reused scratch holds stale set bits)."""
    g = torch.Generator(device='cuda').manual_seed(2)

    def rand(B, K, frac):
        return torch.rand(B, K, device='cuda', generator=g) < frac

    def prefix(B, K, n):
        return (torch.arange(K, device='cuda') < n).expand(B, K)

    cases = []
    for K in (1, 33, 1000):
        s = _nms_scene(g, BATCH, K)
        cases += [(f'K={K} all valid', s, rand(BATCH, K, 1.0), 0.45),
                  (f'K={K} half valid', s, rand(BATCH, K, 0.5), 0.45)]
    s = _nms_scene(g, BATCH, 1024)
    cases += [('overlap K=1024 all valid', s, rand(BATCH, 1024, 1.0), 0.45),
              ('overlap K=1024 half valid (after all valid)', s,
               rand(BATCH, 1024, 0.5), 0.45),
              ('K=1024 valid prefix of 128', s, prefix(BATCH, 1024, 128),
               0.45),
              ('K=1024 no valid candidate', s, rand(BATCH, 1024, 0.0),
               0.45)]
    s = _nms_scene(g, BATCH, 2048)
    cases.append(('K=2048 all valid', s, rand(BATCH, 2048, 1.0), 0.45))
    s = _nms_scene(g, 2, ANCHORS)
    cases += [(f'K={ANCHORS} all valid', s, rand(2, ANCHORS, 1.0), 0.45),
              (f'K={ANCHORS} random valid (after all valid)', s,
               rand(2, ANCHORS, 0.7), 0.45)]
    s = _nms_scene(g, 1, 16000)   # lanes that own more than one word
    cases.append(('K=16000 70 % valid', s, rand(1, 16000, 0.7), 0.45))
    cases.append(('identical and zero-area boxes',
                  _degenerate_scene(g, BATCH, 256), rand(BATCH, 256, 1.0),
                  0.45))
    # chains at threshold 0.3: (length, lone boxes before it in each image)
    chains = {'64-box chain': (64, [0] * BATCH),
              '2000-box chain, 0-3 lone boxes first': (2000, [0, 1, 2, 3])}
    cases += [('64-box chain', _chain(64)[None].repeat(BATCH, 1, 1),
               rand(BATCH, 64, 1.0), 0.3),
              ('2000-box chain, 0-3 lone boxes first',
               torch.stack([_chain(2000, b, 3 - b) for b in range(4)]),
               rand(4, 2003, 1.0), 0.3)]
    worst = 0.0
    for name, boxes, valid, thr in cases:
        keep = nms.nms_keep(boxes, valid, thr)
        want = nms.nms_keep_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        same = torch.equal(keep, want)
        worst = max(worst, (keep.float() - want.float()).abs().max().item())
        print(f'[kernel2] {name}: B={boxes.shape[0]} K={boxes.shape[1]} '
              f'keep masks bit-identical={same} kept={int(keep.sum())} of '
              f'{int(valid.sum())} valid')
        require(same, f'kernel 2 keep mask differs ({name})')
        n, leads = chains.get(name, (0, []))
        for b, lead in enumerate(leads):
            link = keep[b, lead:lead + n]
            require(bool(link[::2].all()) and not bool(link[1::2].any())
                    and bool(keep[b, :lead].all())
                    and bool(keep[b, lead + n:].all()),
                    f'kernel 2 {name}: greedy keeps every other box and '
                    f'every lone box')
        del keep, want

    # K past the scan's default 48 KB of shared memory (one word per 32
    # candidates): a chain of 400,000 boxes, a 20 GB bitmask. The plain
    # version's (K, K) intermediates would not fit; greedy keeps every
    # other box.
    K = 400_000
    keep = nms.nms_keep(_chain(K)[None], torch.ones(1, K, dtype=torch.bool,
                                                    device='cuda'), 0.3)[0]
    ok = bool(keep[::2].all()) and not bool(keep[1::2].any())
    print(f'[kernel2] {K}-box chain: B=1 keeps every other box={ok}')
    require(ok, f'kernel 2 {K}-box chain: greedy keeps every other box')
    del keep
    return worst


def _obj_inputs(g, A, C, dtype, normalize_obj):
    """obj (B, A, 512) in `dtype` (unit rows unless normalize_obj; row
    (0, min(3, A-1)) zero) and unit text (B, C, 512) whose rows DUP_ROWS
    copy row 3."""
    obj = torch.randn(BATCH, A, EMBED, device='cuda', generator=g)
    if not normalize_obj:
        obj = obj / obj.norm(dim=-1, keepdim=True)
    obj[0, min(3, A - 1)] = 0.0
    t = torch.randn(BATCH, C, EMBED, device='cuda', generator=g)
    t = t / t.norm(dim=-1, keepdim=True)
    for r in DUP_ROWS:
        if r < C:
            t[:, r] = t[:, 3]            # exact tie: class 3 must win
    return obj.to(dtype), t


def _check_unprojected(sim, obj, t, num_valid, normalize_obj, tag):
    """Kernel 3 vs its plain version on the same inputs; returns the worst
    score difference."""
    s, i = sim.fused_similarity_argmax(obj, t, num_valid,
                                       normalize_obj=normalize_obj)
    ps, pi = sim.similarity_argmax_reference_plain(obj, t, num_valid,
                                                   normalize_obj)
    raw = torch.matmul(obj.float(), t.to(obj.dtype).float().transpose(1, 2))
    if num_valid is not None:
        raw[..., num_valid:] = sim.NEG
    tie = _near_ties(raw, obj.float().norm(dim=-1).clamp_min(1e-12))
    del raw
    torch.cuda.synchronize()
    err = (s - ps).abs().max().item()
    bad = ((i != pi) & ~tie).sum().item()
    print(f'[kernel3] {tag}: max|score-plain|={err:.3e} (tol {SIM_ATOL:g}) '
          f'id mismatches outside near-ties={bad} near-tie anchors '
          f'exempt={int(tie.sum())}')
    require(err <= SIM_ATOL, f'kernel 3 scores disagree ({tag})')
    require(bad == 0, f'kernel 3 ids disagree ({tag})')
    _require_ids(i, num_valid, t.shape[1], f'kernel 3 ({tag})')
    z = min(3, obj.shape[1] - 1)
    require(s[0, z].item() == 0.0 and i[0, z].item() == 0,
            f'kernel 3 zero obj row ({tag})')
    return err


def phase_kernel3(sim):
    """Returns the worst score difference per input type."""
    g = torch.Generator(device='cuda').manual_seed(4)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype] = 0.0
        for A, C, nv, normalize_obj in K3_CASES:
            obj, t = _obj_inputs(g, A, C, dtype, normalize_obj)
            tag = (f'{str(dtype)[6:]:8s} B={BATCH} A={A:5d} E={EMBED} '
                   f'C={C:4d} num_valid={nv} normalize_obj={normalize_obj}')
            worst[dtype] = max(worst[dtype], _check_unprojected(
                sim, obj, t, nv, normalize_obj, tag))
            del obj, t
    return worst


def phase_text(card: str):
    """The full-width tower on the card vs the CPU, then the timed
    1203-class vocabulary builds. Returns the fp32 LVIS vocabulary."""
    from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder, _bucket
    from yoloclip_tpu_torch.text.vocab import VocabularyBuilder
    cpu = CLIPTextEncoder(seed=0, device='cpu')
    gpu = CLIPTextEncoder(seed=0, device='cuda')
    require(cpu.model.layers == 12 and cpu.model.width == 512
            and sum(p.numel() for p in cpu.model.parameters()) > 60e6,
            'text tower is not ViT-B/32 at full width')
    require(torch.equal(cpu.model.token_embedding.weight,
                        gpu.model.token_embedding.weight.cpu()),
            'card and CPU towers hold different weights')
    same_ids = np.array_equal(cpu.tokenizer.tokenize(PROMPTS),
                              gpu.tokenizer.tokenize(PROMPTS))
    want, got = cpu(PROMPTS), gpu(PROMPTS)
    err = (got.cpu() - want).abs().max().item()
    print(f'[text] ViT-B/32 tower ({sum(p.numel() for p in gpu.model.parameters()) / 1e6:.1f}M '
          f'params, seeded) fp32 TF32 off, {len(PROMPTS)} prompts incl. '
          f'non-ASCII: card vs CPU max|emb diff|={err:.3e} (tol '
          f'{TEXT_ATOL:g}); token ids identical={same_ids}')
    require(same_ids, 'token ids differ')
    require(err <= TEXT_ATOL, 'text tower: card and CPU disagree')
    del cpu, gpu

    vocabs = {}
    for dtype in ('float32', 'bfloat16'):
        enc = CLIPTextEncoder(seed=0, dtype=dtype, device='cuda')
        builder = VocabularyBuilder(enc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tokens = enc.tokenizer.tokenize(
            [tp.format(n) for n in LVIS_NAMES for tp in builder.prompt_templates])
        t_tok = time.perf_counter() - t0
        t0 = time.perf_counter()
        v = builder.build_online_vocabulary(LVIS_NAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        nb = _bucket(len(tokens))
        padded = np.concatenate(
            [tokens, np.tile(tokens[-1:], (nb - len(tokens), 1))])
        tower_ms = cuda_ms(lambda: enc.encode_tokens(padded), iters=3,
                           warmup=1)
        require(v.shape == (LVIS_C, EMBED) and bool(torch.isfinite(v).all()),
                'vocabulary shape or values')
        require(torch.allclose(v.norm(dim=-1), torch.ones(LVIS_C,
                                                           device='cuda'),
                               atol=1e-5), 'vocabulary rows not unit')
        vocabs[dtype] = v
        print(f'[text] vocabulary build {dtype}: {LVIS_C} classes x 5 '
              f'templates = {len(tokens)} prompts, bucketed to {nb}: '
              f'{wall * 1e3:.1f} ms wall (host tokenization alone '
              f'{t_tok * 1e3:.1f} ms), tower on ({nb}, 77) tokens '
              f'{tower_ms:.1f} ms (CUDA events), peak memory above the '
              f'tensors held before {peak:.2f} GiB  [{card}]')
        del enc, builder
    d = (vocabs['bfloat16'] - vocabs['float32']).abs().max().item()
    print(f'[text] bf16 vs fp32 vocabulary: max|diff|={d:.3e}')
    return vocabs['float32']


def _smoke_frames(device) -> torch.Tensor:
    """The run's BATCH seeded 480x640 uint8 frames on `device`."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randint(0, 256, (BATCH, 480, 640, 3),
                                        dtype=np.uint8)).to(device)


def _write_vocab(path: str) -> None:
    from yoloclip_tpu_torch.config import COCO_CLASS_NAMES
    rng = np.random.RandomState(0)
    v = rng.randn(len(COCO_CLASS_NAMES), EMBED)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    with open(path, 'w') as f:
        json.dump({n: row.tolist() for n, row in zip(COCO_CLASS_NAMES, v)},
                  f)


def _finite(out) -> bool:
    return all(torch.isfinite(out[k].float()).all().item()
               for k in ('boxes', 'scores'))


def _detector(vocab_path, dtype='float32', device='cuda', model_kw=None,
              **cfg_kw):
    """Variant 'n', 640 px, the JSON vocabulary, weights from seed 0;
    device letterbox unless cfg_kw says otherwise; model_kw: ModelConfig
    fields (the stems)."""
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    cfg = InferenceConfig(**{'host_preprocess': False, **cfg_kw})
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype, **(model_kw or {})))
    return YOLOCLIPDetector(cfg, vocab_path=vocab_path, device=device,
                            seed=0)


def phase_main_path(sim, nms, vocab_path, frames):
    """Returns the fp32 and bf16 detectors and the launches of the run."""
    det, bf = _detector(vocab_path), _detector(vocab_path, 'bfloat16')
    require(len(det.class_names) == 80, 'COCO-80 vocabulary')
    conf = det.conf_threshold

    sim.launches = sim.launches_bf16 = 0
    nms.launches = 0
    out = det.detect_batch(frames)
    det.conf_threshold = -1.0
    out_all = det.detect_batch(frames)
    det.conf_threshold = conf
    dets = det.detect(frames[0].cpu().numpy())
    out_bf = bf.detect_batch(frames)
    # every anchor a candidate: K = nms_topk = 8400, above the old limit
    cfg = det.config
    det.config = dataclasses.replace(cfg, nms_topk=ANCHORS)
    det.conf_threshold = -1.0
    before = nms.launches
    out_wide = det.detect_batch(frames)
    wide_launches = nms.launches - before
    det.config, det.conf_threshold = cfg, conf
    torch.cuda.synchronize()
    launches = {'similarity': sim.launches - sim.launches_bf16,
                'similarity_bf16': sim.launches_bf16, 'nms': nms.launches}
    print(f'[main] launches on the main path (fp32 detect_batch x2, detect, '
          f'bf16 detect_batch, fp32 detect_batch at nms_topk={ANCHORS}): '
          f'{launches}')
    require(all(n > 0 for n in launches.values()),
            'a kernel of the main path never launched')
    require(wide_launches == 1,
            f'nms_topk={ANCHORS} detect_batch did not launch kernel 2 once')

    D = det.config.max_detections
    for name, o in (('fp32 conf 0.25', out), ('fp32 conf -1.0', out_all),
                    ('bf16 conf 0.25', out_bf),
                    (f'fp32 conf -1.0 nms_topk={ANCHORS}', out_wide)):
        require(o['boxes'].shape == (BATCH, D, 4), 'detect_batch shape')
        require(_finite(o), 'non-finite detect_batch output')
        print(f'[main] detect_batch {name}: counts '
              f'min={int(o["count"].min())} max={int(o["count"].max())} '
              f'saturated={int(o["prefilter_saturated"].sum())}/{BATCH}')
    require(bool(out_all['prefilter_saturated'].all()),
            'conf -1.0 must saturate the 1024-candidate prefilter')
    require(bool((out_all['count'] > 0).all()), 'conf -1.0 keeps boxes')
    require(not bool(out_wide['prefilter_saturated'].any())
            and bool((out_wide['count'] > 0).all()),
            f'nms_topk={ANCHORS} holds every anchor and keeps boxes')
    require(all(np.isfinite(d['score']) for d in dets), 'detect scores')
    print(f'[main] detect on one 480x640 frame: {len(dets)} detections')
    return det, bf, launches


def phase_cross_device(det, vocab_path, frames) -> None:
    """Pre-NMS outputs of a bs=2 fp32 run on the card vs on the CPU."""
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch
    cpu = YOLOCLIPDetector(InferenceConfig(host_preprocess=False),
                           vocab_path=vocab_path, device='cpu', seed=0)
    x = frames[:2]
    with torch.inference_mode():
        canv, _ = letterbox_batch(x, det.image_size)
        got = det.model(canv, det.offline_vocabulary, fused_scores=True)
        canv_c, _ = letterbox_batch(x.cpu(), det.image_size)
        want = cpu.model(canv_c, cpu.offline_vocabulary)
    top2 = want['similarity'].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP
    s_err = (got['scores'].cpu() - want['scores']).abs().max().item()
    bad_ids = ((got['class_ids'].cpu() != want['class_ids']) & ~tie).sum()
    gb, wb = got['boxes'].cpu(), want['boxes']
    box_ok = torch.allclose(gb, wb, rtol=XDEV_BOX_RTOL, atol=XDEV_BOX_ATOL)
    print(f'[xdev] bs=2 fp32 card vs CPU: max|score diff|={s_err:.3e} '
          f'(tol {XDEV_SCORE_ATOL:g}); id mismatches outside near-ties='
          f'{int(bad_ids)}; near-tie anchors exempt={int(tie.sum())}; '
          f'boxes within rtol {XDEV_BOX_RTOL:g} atol {XDEV_BOX_ATOL:g}='
          f'{box_ok} (max rel '
          f'{((gb - wb).abs() / wb.abs().clamp_min(1)).max().item():.2e})')
    require(s_err <= XDEV_SCORE_ATOL, 'card and CPU scores disagree')
    require(int(bad_ids) == 0, 'card and CPU class ids disagree')
    require(box_ok, 'card and CPU boxes disagree')


def phase_prompts(sim, nms, frames, lvis_vocab):
    """The LVIS-scale prompt path. Returns (detector, launches)."""
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch
    cfg = InferenceConfig(host_preprocess=False)
    t0 = time.perf_counter()
    det = YOLOCLIPDetector(cfg, class_names=LVIS_NAMES, device='cuda',
                           seed=0)
    torch.cuda.synchronize()
    print(f'[prompts] detector from {LVIS_C} class names (vocabulary built '
          f'by the text tower on the card) in '
          f'{time.perf_counter() - t0:.2f} s')
    require(det.offline_vocabulary.shape == (LVIS_C, EMBED),
            'LVIS vocabulary shape')
    vdiff = (det.offline_vocabulary - lvis_vocab).abs().max().item()
    print(f'[prompts] its vocabulary vs the timed fp32 build: max|diff|='
          f'{vdiff:.3e}')
    require(vdiff <= 1e-5, 'the detector built another vocabulary')

    sim.launches = sim.launches_bf16 = nms.launches = 0
    sim.unprojected_launches = sim.unprojected_launches_bf16 = 0
    alpha, beta = cfg.model.cls_alpha, cfg.model.cls_beta
    with torch.inference_mode():
        canv, _ = letterbox_batch(frames, det.image_size)
        unf = det.model(canv, det.offline_vocabulary)
        txt = unf['text_embeddings']
        txt = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        raw3, i3 = sim.fused_similarity_argmax(unf['obj_embeddings'], txt,
                                               normalize_obj=True)
        s3 = alpha * raw3 + beta
        # the same unfolded scoring on bf16 rows and text
        raw3b, i3b = sim.fused_similarity_argmax(
            unf['obj_embeddings'].bfloat16(), txt.bfloat16(),
            normalize_obj=True)
        folded = det.model(canv, det.offline_vocabulary, fused_scores=True)
    out = det.detect_batch(frames)
    dets = det.detect(frames[0].cpu().numpy(), text_prompts=FREE_PROMPTS)
    torch.cuda.synchronize()
    launches = {'similarity': sim.launches,
                'similarity_unprojected': (sim.unprojected_launches
                                           - sim.unprojected_launches_bf16),
                'similarity_unprojected_bf16': sim.unprojected_launches_bf16,
                'nms': nms.launches}
    print(f'[prompts] launches on the prompt path: {launches}')
    require(all(n > 0 for n in launches.values()),
            'a kernel of the prompt path never launched')

    top2 = unf['similarity'].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < SIM_ATOL
    for name, ref in (('model unfused', unf), ('folded kernel 1', folded)):
        err = (s3 - ref['scores']).abs().max().item()
        bad = ((i3 != ref['class_ids']) & ~tie).sum().item()
        print(f'[prompts] unfolded scoring (kernel 3, normalize_obj) vs '
              f'{name}: B={BATCH} A={ANCHORS} C={LVIS_C} max|score diff|='
              f'{err:.3e} (tol {SIM_ATOL:g}); id mismatches outside '
              f'near-ties={bad}; near-tie anchors exempt={int(tie.sum())}')
        require(err <= SIM_ATOL, f'kernel 3 path disagrees with {name}')
        require(bad == 0, f'kernel 3 path ids disagree with {name}')
    err_b = (raw3b - raw3).abs().max().item()
    print(f'[prompts] unfolded scoring in bf16 vs fp32: max|score diff|='
          f'{err_b:.3e} (tol {BF16_PATH_ATOL:g}); ids equal on '
          f'{(i3b == i3).float().mean().item():.4f} of anchors')
    require(raw3b.shape == raw3.shape and err_b <= BF16_PATH_ATOL,
            'bf16 unfolded scoring')
    require(out['boxes'].shape == (BATCH, cfg.max_detections, 4)
            and _finite(out), 'LVIS detect_batch output')
    require(bool((out['class_ids'] < LVIS_C).all()), 'LVIS class ids')
    require(all(np.isfinite(d['score']) and d['class_name'] in FREE_PROMPTS
                for d in dets), 'detect with prompts')
    print(f'[prompts] detect_batch counts min={int(out["count"].min())} '
          f'max={int(out["count"].max())}; detect with {len(FREE_PROMPTS)} '
          f'free-text prompts: {len(dets)} detections')
    del unf, folded
    return det, launches


def _synced_ms(fn, iters: int = 10) -> float:
    """Median wall ms of fn() followed by a synchronise, after 3 warm-up
    calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def _img_per_s(det, frames, iters: int = 10, eager: bool = False
               ) -> float:
    """detect_batch img/s: its program, or with eager=True its eager body
    (the path before the programs)."""
    fn = ((lambda: det._detect_batch_eager(frames, det.offline_vocabulary))
          if eager else (lambda: det.detect_batch(frames)))
    return frames.shape[0] / _synced_ms(fn, iters) * 1e3


def _stage_ms(det, frames, sim) -> dict:
    """Device time of each detect_batch stage alone, in order (CUDA events,
    10 calls after 3 warm-up); the stages' inputs are made once first."""
    from yoloclip_tpu_torch.models.heads import decode_boxes
    from yoloclip_tpu_torch.ops.nms import batched_nms
    from yoloclip_tpu_torch.ops.preprocess import (letterbox_batch,
                                                   rescale_boxes)
    m, cfg = det.model, det.model.cfg
    text, _ = det._text(None)
    ms = {}
    with torch.inference_mode():
        ms['letterbox'] = cuda_ms(lambda: letterbox_batch(
            frames, det.image_size), iters=10)
        canv, scale = letterbox_batch(frames, det.image_size)
        dt = m.box_head.box_convs[0][2].weight.dtype
        x = canv.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=torch.channels_last)
        txt = text[None].expand(BATCH, -1, -1).float()
        ms['backbone'] = cuda_ms(lambda: m.backbone(x), iters=10)
        feats = m.backbone(x)
        ms['neck'] = cuda_ms(lambda: m.neck(feats, txt), iters=10)
        pan, ptxt = m.neck(feats, txt)
        txt_n = ptxt / ptxt.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        ms['contrastive towers'] = cuda_ms(lambda: [
            hd(f, return_hidden=True)
            for hd, f in zip(m.contrastive_heads, pan)], iters=10)
        hidden = [hd(f, return_hidden=True)
                  for hd, f in zip(m.contrastive_heads, pan)]
        ms['similarity kernel x 3 levels'] = cuda_ms(lambda: [
            sim.fused_projected_similarity_argmax(
                h.permute(0, 2, 3, 1).reshape(BATCH, -1, h.shape[1]),
                txt_n, k, b) for h, k, b in hidden], iters=10)
        ms['box head'] = cuda_ms(lambda: m.box_head(pan), iters=10)
        bp = m.box_head(pan)
        ms['DFL decode'] = cuda_ms(lambda: decode_boxes(
            bp, cfg.strides, cfg.reg_max), iters=10)
        out = m(canv, text, fused_scores=True)
        boxes = rescale_boxes(out['boxes'], scale, tuple(frames.shape[1:3]))
        ms['rescale + NMS'] = cuda_ms(lambda: batched_nms(
            boxes, out['scores'], out['class_ids'], **det._nms_args()),
            iters=10)
        for topk, conf in ((det.config.nms_topk, -1.0), (ANCHORS, None),
                           (ANCHORS, -1.0)):
            kw = dict(det._nms_args(), topk=topk)
            if conf is not None:
                kw['conf_threshold'] = conf
            ms[f'rescale + NMS (nms_topk={topk}, conf '
               f'{kw["conf_threshold"]:g})'] = cuda_ms(lambda: batched_nms(
                   boxes, out['scores'], out['class_ids'], **kw), iters=10)
        # the same stage with the host out of the way (CUDA-graph replay)
        ms['rescale + NMS, device only'] = graph_ms(lambda: batched_nms(
            boxes, out['scores'], out['class_ids'], **det._nms_args()),
            iters=10)
        ms['whole model forward'] = cuda_ms(
            lambda: m(canv, text, fused_scores=True), iters=10)
    ms['detect_batch'] = cuda_ms(lambda: det.detect_batch(frames), iters=10)
    return ms


def _time_folded(sim, g, C, dtype, card):
    """Kernel 1 over the three levels at C classes: (wrapper ms, kernel
    alone ms, plain ms, bound ms, bound_by)."""
    tot = [0.0, 0.0, 0.0]
    for A in LEVELS:
        h, t, K, b = _sim_inputs(g, A, C, dtype)
        ops = sim._prepare_folded(dtype, t, K, b)
        ms = (cuda_ms(lambda: sim.fused_projected_similarity_argmax(
                  h, t, K, b)),
              cuda_ms(lambda: sim._launch(h, ops, C, EMBED, C)),
              cuda_ms(lambda: sim.similarity_argmax_plain(h, t, K, b)))
        tot = [x + y for x, y in zip(tot, ms)]
        print(f'[time] similarity {str(dtype)[6:]:8s} B={BATCH} A={A:5d} '
              f'C={C:4d}: wrapper {ms[0]:.4f} ms (kernel alone {ms[1]:.4f}),'
              f' plain {ms[2]:.4f} ms')
        del h, t, ops
    esize = torch.finfo(dtype).bits // 8
    flops = 2 * BATCH * ANCHORS * HIDDEN * (C + EMBED)
    # h, tp (B, C, Kd) and K in the input type; cb, bias fp32; the outputs
    nbytes = (BATCH * ANCHORS * HIDDEN * esize + BATCH * C * HIDDEN * esize
              + BATCH * C * 4 + HIDDEN * EMBED * esize + EMBED * 4
              + BATCH * ANCHORS * 8)
    bms, bby = sim_bound(flops, nbytes, dtype)
    print(f'[time] similarity {str(dtype)[6:]} C={C} all three levels: '
          f'wrapper {tot[0]:.4f} ms, kernel alone {tot[1]:.4f} ms, plain '
          f'{tot[2]:.4f} ms, bound {bms:.4f} ms ({bby}; {flops / 1e9:.1f} '
          f'GFLOP)  [{card}]')
    return tot[0], tot[1], tot[2], bms, bby


def phase_timing(det, bf, lvis_det, frames, sim, nms, card: str):
    torch.cuda.reset_peak_memory_stats()
    fp32 = _img_per_s(det, frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    bf16 = _img_per_s(bf, frames)
    fp32_e, bf16_e = (_img_per_s(d, frames, eager=True) for d in (det, bf))
    print(f'[time] detect_batch bs={BATCH} 640px COCO-80 variant n, frames '
          f'480x640 uint8 already on the card, conf 0.25: '
          f'fp32 {fp32:.1f} img/s (peak {peak:.2f} GiB), '
          f'bf16 {bf16:.1f} img/s (programs); eager bodies: fp32 '
          f'{fp32_e:.1f}, bf16 {bf16_e:.1f} img/s  [{card}]')
    lvis = _img_per_s(lvis_det, frames)
    lvis_e = _img_per_s(lvis_det, frames, eager=True)
    print(f'[time] detect_batch bs={BATCH} 640px LVIS-scale {LVIS_C} '
          f'classes (folded path) fp32: {lvis:.1f} img/s (program), eager '
          f'body {lvis_e:.1f} img/s  [{card}]')
    for name, d in (('COCO-80 fp32', det), ('COCO-80 bf16', bf),
                    (f'LVIS-{LVIS_C} fp32', lvis_det)):
        ms = _stage_ms(d, frames, sim)
        print(f'[stages] {name}, bs={BATCH}, 640 px, device ms of each '
              f'stage alone: ' + ', '.join(f'{k} {v:.3f}'
                                            for k, v in ms.items())
              + f'  [{card}]')

    g = torch.Generator(device='cuda').manual_seed(3)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        res[('similarity', dtype)] = _time_folded(sim, g, 80, dtype, card)
        _time_folded(sim, g, LVIS_C, dtype, card)

    for dtype in (torch.float32, torch.bfloat16):
        obj, t = _obj_inputs(g, ANCHORS, LVIS_C, dtype, True)
        tc = t.to(dtype)
        mw = cuda_ms(lambda: sim.fused_similarity_argmax(
            obj, t, normalize_obj=True), iters=10)
        mk = cuda_ms(lambda: sim._launch_unprojected(obj, tc, LVIS_C, True),
                     iters=10)
        mp = cuda_ms(lambda: sim.similarity_argmax_reference_plain(
            obj, t, None, True), iters=10)
        esize = torch.finfo(dtype).bits // 8
        flops = 2 * BATCH * ANCHORS * EMBED * LVIS_C
        # obj and text in the input type; the outputs
        nbytes = (BATCH * ANCHORS * EMBED * esize
                  + BATCH * LVIS_C * EMBED * esize + BATCH * ANCHORS * 8)
        bms, bby = sim_bound(flops, nbytes, dtype)
        print(f'[time] similarity unprojected {str(dtype)[6:]} B={BATCH} '
              f'A={ANCHORS} E={EMBED} C={LVIS_C} normalize_obj: wrapper '
              f'{mw:.4f} ms (kernel alone {mk:.4f}), plain {mp:.4f} ms, '
              f'bound {bms:.4f} ms ({bby}; {flops / 1e9:.1f} GFLOP)'
              f'  [{card}]')
        res[('unprojected', dtype)] = (mw, mk, mp, bms, bby)
        del obj, t, tc

    res[('nms', torch.float32)] = time_nms(nms, card)
    return res


def time_nms(nms, card: str):
    """Kernel 2 in each of NMS_SCENES: through its wrapper (CUDA events
    around back-to-back calls, so the host's launch cost shows), alone on
    prepared operands and its mask build and scan apart (device time, from
    CUDA-graph replays), beside its plain
    version (where its (B, K, K) intermediates fit) and its bound. Returns
    the first scene's (wrapper ms, alone ms, plain ms, bound ms,
    bound_by)."""
    g = torch.Generator(device='cuda').manual_seed(5)
    first = None
    for B, K, n in NMS_SCENES:
        boxes = _nms_scene(g, B, K)
        valid = (torch.arange(K, device='cuda') < n).repeat(B, 1)
        keep = torch.empty_like(valid)
        mask = nms.scratch(B, K, 'cuda')
        ms = {'wrapper': cuda_ms(lambda: nms.nms_keep(boxes, valid, 0.45))}
        for name, stages in (('alone', nms.BOTH), ('build', nms.BUILD),
                             ('scan', nms.SCAN)):
            ms[name] = graph_ms(lambda: nms._run(boxes, valid, mask, keep,
                                                 0.45, stages))
        plain = (cuda_ms(lambda: nms.nms_keep_plain(boxes, valid, 0.45),
                         iters=5) if B * K * K <= 2**28 else None)
        # 12 fp32 operations per IoU pair with both sides valid; boxes,
        # valid and keep once
        pairs = B * n * (n - 1) // 2
        bms, bby = bound(12 * pairs, B * K * (16 + 1 + 1), FP32_CORES)
        kept = int(nms.nms_keep(boxes, valid, 0.45).sum())
        print(f'[time] nms keep B={B} K={K} valid prefix {n}: wrapper '
              f'{ms["wrapper"]:.4f} ms (events, host included), kernel '
              f'alone {ms["alone"]:.4f} (graph replay; mask build '
              f'{ms["build"]:.4f}, scan {ms["scan"]:.4f}), plain '
              + (f'{plain:.4f} ms' if plain is not None else
                 'not run ((B, K, K) intermediates too large)')
              + f', bound {bms:.4f} ms ({bby}), kept {kept}  [{card}]')
        if first is None:
            first = (ms['wrapper'], ms['alone'], plain, bms, bby)
        del boxes, valid, keep, mask
    return first


# ---------------------------------------------------------------------------
# Serving: the native host library, the canvas path, the server, streaming,
# reparam, the HTTP front end and the CLIs.
# ---------------------------------------------------------------------------

FRAME_SIZES = ((480, 640), (720, 1280), (1080, 1920))
SERVE_CLIENTS, SERVE_REQUESTS = 16, 512
STREAMS, STREAM_HW, STREAM_STEPS = 8, (1080, 1920), 20


def _counts(sim, nms) -> dict:
    return {'similarity': sim.launches - sim.launches_bf16,
            'similarity_bf16': sim.launches_bf16, 'nms': nms.launches}


def _zero_counts(sim, nms) -> None:
    sim.launches = sim.launches_bf16 = nms.launches = 0
    sim.unprojected_launches = sim.unprojected_launches_bf16 = 0


def _mixed_frames(seed: int, n: int):
    """n seeded uint8 frames cycling through FRAME_SIZES."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, FRAME_SIZES[i % 3] + (3,), dtype=np.uint8)
            for i in range(n)]


def _pre_nms_scores(det, canvases):
    """The detector's pre-NMS scores (B, A) and the similarity's near-tie
    mask (None on the fused path) on host canvases (B, th, tw, 3) uint8,
    run as the canvas program runs them."""
    x = torch.from_numpy(np.stack(canvases)).to(det.device).float() / 255.0
    with torch.inference_mode():
        out = det.model(x, det.offline_vocabulary,
                        fused_scores=det._use_fused_similarity())
    tie = None
    if 'similarity' in out:
        top2 = out['similarity'].topk(2, dim=-1).values
        tie = ((top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP).cpu()
    return out['scores'].float().cpu(), out['class_ids'].cpu(), tie


def _check_detections(tag, got, want, want_scores, delta, topk,
                      score_atol=XDEV_SCORE_ATOL):
    """got, want: one frame's detection lists (score order) from two runs
    whose pre-NMS scores differ by at most `delta`; want_scores: the `want`
    run's pre-NMS scores (A,). Greedy NMS visits candidates in score
    order, so both runs keep the same candidates among those ranked above
    the first pair of the top-(topk + 1) whose order a difference of delta
    could flip (scores within 2 delta): those detections must agree (class,
    score within XDEV_SCORE_ATOL, int box within 1 px). Returns (compared,
    total)."""
    s = torch.sort(want_scores, descending=True).values[:topk + 1].numpy()
    flip = np.flatnonzero(s[:-1] - s[1:] <= 2 * delta + 1e-7)
    cut = float(s[flip[0]]) if flip.size else -np.inf
    sure_w = [d for d in want if d['score'] > cut]
    sure_g = [d for d in got if d['score'] > cut + delta]
    require(len(sure_g) == len(sure_w),
            f'{tag}: {len(sure_g)} vs {len(sure_w)} detections above the '
            f'first possible order flip (score {cut:.6f})')
    for a, b in zip(sure_g, sure_w):
        require(a['class_id'] == b['class_id']
                and abs(a['score'] - b['score']) <= score_atol
                and max(abs(p - q) for p, q in zip(a['box'], b['box'])) <= 1,
                f'{tag}: detections differ: {a} vs {b}')
    return len(sure_w), len(want)


def phase_native(det, card: str) -> None:
    """The card detector's host letterbox: native, byte for byte; within 1
    LSB of the numpy bilinear resize; host ms per frame."""
    from yoloclip_tpu_torch import native
    from yoloclip_tpu_torch.data.coco import _resize_numpy_bilinear
    try:
        import cv2
    except ImportError:
        cv2 = None
    require(native.available(), 'the native library did not load')
    print(f'[native] library loaded; JPEG/PNG codecs compiled in: '
          f'{native.codecs_available()}; cv2: '
          f'{cv2.__version__ if cv2 else "not importable"}')
    th, tw = det.image_size
    frames = _mixed_frames(20, 6)
    for f in frames[:3]:
        h, w = f.shape[:2]
        canvas, scale = det._host_letterbox(f)
        ncanvas, nscale = native.letterbox_u8(f, det.image_size)
        require(np.array_equal(canvas, ncanvas) and scale == nscale,
                'the detector host letterbox is not the native library')
        rh, rw = int(h * scale), int(w * scale)
        ref = _resize_numpy_bilinear(f, rw, rh)
        lsb = int(np.abs(canvas[:rh, :rw].astype(int) - ref).max())
        cvd = (int((canvas[:rh, :rw] != cv2.resize(f, (rw, rh))).sum())
               if cv2 else 'not compared')
        require(lsb <= 1 and not canvas[rh:].any()
                and not canvas[:, rw:].any(),
                f'native canvas {h}x{w}: {lsb} LSB from the numpy resize')
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            det._host_letterbox(f)
            times.append(time.perf_counter() - t0)
        print(f'[native] host letterbox backend: native (canvas '
              f'byte-identical to native.letterbox_u8; cv2.resize differs '
              f'in {cvd} bytes); {h}x{w} -> {rh}x{rw} in a {th}x{tw} '
              f'canvas: max |canvas - numpy bilinear| = {lsb} LSB (tol 1); '
              f'{statistics.median(times) * 1e3:.3f} ms per frame (median '
              f'of 20, one thread)  [{card}]')
    # 8 threads, each letterboxing 24 frames of 1080x1920
    big = frames[2]
    t0 = time.perf_counter()
    threads = [threading.Thread(
        target=lambda: [det._host_letterbox(big) for _ in range(24)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    print(f'[native] 8 threads x 24 frames of 1080x1920: {192 / wall:.1f} '
          f'frames/s ({wall / 192 * 1e3:.3f} ms per frame wall, '
          f'{os.cpu_count()} host cores)  [{card}]')


def phase_canvas(sim, nms, vocab_path) -> tuple:
    """detect() on the canvas path, card vs CPU. Returns (the fp32 card
    detector at conf -1.0 on the canvas path, the launches)."""
    sdet = _detector(vocab_path, host_preprocess='auto', conf_threshold=-1.0)
    cpu = _detector(vocab_path, device='cpu', host_preprocess='auto',
                    conf_threshold=-1.0)
    frame = _mixed_frames(30, 3)[1]                  # 720x1280
    require(sdet._host_letterbox_available()
            and cpu._host_letterbox_available(), 'no host letterbox')
    _zero_counts(sim, nms)
    got = sdet.detect(frame)
    torch.cuda.synchronize()
    launches = _counts(sim, nms)
    require(launches['similarity'] > 0 and launches['nms'] > 0,
            'the canvas path did not launch kernels 1 and 2')
    want = cpu.detect(frame)
    canvas, _ = sdet._host_letterbox(frame)
    gs, gi, _ = _pre_nms_scores(sdet, [canvas])
    ws, wi, tie = _pre_nms_scores(cpu, [canvas])
    delta = (gs - ws).abs().max().item()
    bad = int(((gi != wi) & ~tie).sum())
    n, total = _check_detections('canvas detect', got, want, ws[0], delta,
                                 sdet.config.nms_topk)
    print(f'[canvas] detect() host_preprocess=auto on a 720x1280 frame, '
          f'fp32 conf -1.0: card vs CPU pre-NMS max|score diff|='
          f'{delta:.3e} (tol {XDEV_SCORE_ATOL:g}), id mismatches outside '
          f'near-ties={bad}; {len(got)} vs {len(want)} detections, the top '
          f'{n} (above the first possible order flip) identical; launches '
          f'{launches}')
    require(delta <= XDEV_SCORE_ATOL and bad == 0,
            'canvas path: card and CPU disagree')
    del cpu
    return sdet, launches


def phase_server(sim, nms, sdet, bdet, card: str) -> dict:
    """Returns the launches of the phase."""
    from yoloclip_tpu_torch.inference.server import DetectionServer
    total = {k: 0 for k in ('similarity', 'similarity_bf16', 'nms')}

    # fp32, conf -1.0: 8 mixed requests in one batch against detect()
    frames = _mixed_frames(40, 8)
    _zero_counts(sim, nms)
    with DetectionServer(sdet, max_batch=BATCH, max_delay_ms=300.0) as srv:
        futs = [srv.submit(f) for f in frames]
        got = [f.result(timeout=120) for f in futs]
        st = srv.stats()
    torch.cuda.synchronize()
    total = {k: total[k] + v for k, v in _counts(sim, nms).items()}
    require(st['batches'] == 1 and st['mean_bucket'] == 8,
            f'8 requests did not make one bucket-8 batch: {st}')
    want = [sdet.detect(f) for f in frames]
    canvases = [sdet._host_letterbox(f)[0] for f in frames]
    batch_scores, _, _ = _pre_nms_scores(sdet, canvases)
    single = [_pre_nms_scores(sdet, [c])[0][0] for c in canvases]
    delta = max((batch_scores[i] - single[i]).abs().max().item()
                for i in range(8))
    compared = [_check_detections(f'server request {i}', g, w, single[i],
                                  delta, sdet.config.nms_topk)
                for i, (g, w) in enumerate(zip(got, want))]
    print(f'[server] fp32 conf -1.0, 8 requests ({", ".join(f"{h}x{w}" for h, w in FRAME_SIZES)} '
          f'mixed) in one bucket-8 batch vs detect() on each frame: '
          f'pre-NMS max|score diff| batch vs single={delta:.3e}; '
          f'detections compared (above the first possible order flip) / '
          f'kept: {compared}')
    require(delta <= XDEV_SCORE_ATOL, 'server batch vs single scores')

    # bf16, conf 0.25: warmup, then 16 clients over 512 frames
    pool = _mixed_frames(41, 24)
    srv = DetectionServer(bdet, max_batch=BATCH, max_delay_ms=5.0)
    seconds = srv.warmup()
    print(f'[server] bf16 warmup() per bucket (s, synchronised): '
          + ', '.join(f'bs={b} {t:.3f}' for b, t in seconds.items())
          + f'  [{card}]')
    per = SERVE_REQUESTS // SERVE_CLIENTS
    for mode in ('closed loop', 'open loop'):
        srv.reset_stats()
        _zero_counts(sim, nms)
        errors = []

        def client(c):
            try:
                frs = [pool[(c * per + i) % len(pool)] for i in range(per)]
                if mode == 'closed loop':
                    for f in frs:
                        srv.detect(f, timeout=120)
                else:
                    for fut in [srv.submit(f) for f in frs]:
                        fut.result(timeout=120)
            except Exception as e:        # reported below, fails the run
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _counts(sim, nms)
        total = {k: total[k] + v for k, v in launches.items()}
        st = srv.stats()
        require(not errors and st['requests'] == SERVE_REQUESTS,
                f'server {mode}: {errors[:1]} {st}')
        require(launches['similarity_bf16'] > 0 and launches['nms'] > 0,
                f'server {mode}: kernels 1 and 2 did not launch')
        print(f'[server] bf16 conf 0.25, {SERVE_CLIENTS} client threads x '
              f'{per} mixed-resolution frames, {mode}: '
              f'{SERVE_REQUESTS / wall:.1f} requests/s, p50 '
              f'{st["p50_latency_ms"]:.2f} ms, p95 '
              f'{st["p95_latency_ms"]:.2f} ms, {st["batches"]} batches, '
              f'mean occupancy {st["mean_occupancy"]:.2f}, mean bucket '
              f'{st["mean_bucket"]:.2f}, launches {launches}  [{card}]')
        if mode == 'open loop':
            print(f'[server] open loop: {wall / st["batches"] * 1e3:.2f} ms '
                  f'a batch of mean occupancy {st["mean_occupancy"]:.2f}')
    _server_breakdown(srv, bdet, pool, card)
    srv.close()
    return total


def _server_breakdown(srv, bdet, pool, card: str) -> None:
    """One full bf16 batch of 32 through the server's dispatch step with
    no other thread running, and its parts: the canvas program on
    canvases already on the card, the upload of the pinned canvases."""
    from yoloclip_tpu_torch.inference.server import _Request
    reqs = []
    for f in (pool * 2)[:BATCH]:
        canvas, scale = bdet._host_letterbox(f)
        reqs.append(_Request(canvas, scale, np.asarray(
            [f.shape[1], f.shape[0]], np.float32), [], None))
    text = bdet.offline_vocabulary

    def dispatch():
        _, done = srv._launch(reqs, BATCH, text)
        for ev in done:
            ev.synchronize()

    th, tw = bdet.image_size
    host = torch.zeros((BATCH, th, tw, 3), dtype=torch.uint8,
                       pin_memory=True)
    canv = host.cuda()
    ones = torch.ones((BATCH, 2), dtype=torch.float32, device='cuda')
    ms = {'dispatch step (assemble + upload + program + download)':
          _synced_ms(dispatch),
          'canvas program on canvases on the card': _synced_ms(
              lambda: bdet._detect_canvases(canv, text, ones[:, 0], ones)),
          'upload of 32 pinned canvases (events)': cuda_ms(
              lambda: host.to('cuda', non_blocking=True), iters=10)}
    print('[server] bf16 batch of 32, one thread, median of 10 synced '
          'calls (ms): ' + ', '.join(f'{k} {v:.2f}' for k, v in ms.items())
          + f'  [{card}]')


def phase_streaming(sim, nms, sdet, bdet, card: str) -> dict:
    """Returns the launches of the fp32 step and of the timed bf16 run,
    each counted from 0 just before it and read just after it."""
    from yoloclip_tpu_torch.cli.stream import _synthetic_source
    from yoloclip_tpu_torch.inference.streaming import StreamingDetector
    source = _synthetic_source(STREAMS, STREAM_HW)
    s32 = StreamingDetector(sdet.model, sdet.offline_vocabulary, STREAMS,
                            STREAM_HW, sdet.config)
    frames = source(0)
    _zero_counts(sim, nms)
    out = s32.step(frames)
    torch.cuda.synchronize()
    step_launches = _counts(sim, nms)
    want = sdet.detect_batch(frames)
    same = all(torch.equal(out[k], want[k]) for k in want)
    print(f'[streaming] fp32 conf -1.0, {STREAMS} x {STREAM_HW[0]}x'
          f'{STREAM_HW[1]}: step vs detect_batch on the same frames '
          f'identical={same} (counts {out["count"].tolist()}); launches '
          f'{step_launches}')
    require(same and set(out) == set(want), 'streaming step vs detect_batch')
    sbf = StreamingDetector(bdet.model, bdet.offline_vocabulary, STREAMS,
                            STREAM_HW, bdet.config)
    sbf.run(source, lambda k, o: None, max_steps=3)       # first-call setup
    counts = []
    _zero_counts(sim, nms)
    stats = sbf.run(source, lambda k, o: counts.append(int(o['count'].sum())),
                    max_steps=STREAM_STEPS)
    torch.cuda.synchronize()
    launches = _counts(sim, nms)
    require(stats['steps'] == STREAM_STEPS and len(counts) == STREAM_STEPS,
            'streaming run')
    require(launches['similarity_bf16'] > 0 and launches['nms'] > 0,
            'streaming run: kernels 1 and 2 did not launch')
    print(f'[streaming] bf16 conf 0.25, {STREAMS} streams x {STREAM_HW[0]}x'
          f'{STREAM_HW[1]} synthetic, {STREAM_STEPS} steps (run(), frames '
          f'assembled on the host, uploaded as uint8): '
          f'{stats["mean_step_ms"]:.2f} ms/step, '
          f'{stats["fps_per_stream"]:.1f} fps/stream '
          f'({STREAMS * stats["fps_per_stream"]:.1f} frames/s); launches '
          f'{launches}  [{card}]')
    return {k: step_launches[k] + launches[k] for k in launches}


def phase_reparam(sim, nms, sdet, det, bf, card: str) -> dict:
    from yoloclip_tpu_torch.ops.nms import batched_nms
    from yoloclip_tpu_torch.ops.reparam import build_reparam_forward
    rng = np.random.RandomState(50)
    canv = torch.from_numpy(rng.randint(0, 256, (BATCH, 640, 640, 3),
                                        dtype=np.uint8)).cuda()
    x = canv.float() / 255.0
    kw = dict(sdet._nms_args(), conf_threshold=-1.0)
    nms_kw = {'conf_threshold': -1.0, 'iou_threshold': kw['iou_threshold'],
              'topk': kw['topk'], 'max_detections': kw['max_detections']}
    _zero_counts(sim, nms)
    fwd = build_reparam_forward(sdet.model, sdet.offline_vocabulary,
                                nms=nms_kw)
    got = fwd(x)
    torch.cuda.synchronize()
    launches = _counts(sim, nms)
    with torch.inference_mode():
        out = sdet.model(x, sdet.offline_vocabulary, fused_scores=True)
        want = batched_nms(out['boxes'], out['scores'], out['class_ids'],
                           **kw)
    same = set(got) == set(want) and all(torch.equal(got[k], want[k])
                                         for k in want)
    print(f'[reparam] fp32 conf -1.0, bs={BATCH} 640x640 canvases: '
          f'build_reparam_forward(nms=...) vs the detector\'s model + '
          f'batched_nms on the same canvases identical={same}; launches '
          f'{launches}')
    require(same, 'reparam vs the detector path')
    require(launches['similarity'] > 0 and launches['nms'] > 0,
            'reparam did not launch kernels 1 and 2')
    for name, d in (('fp32', det), ('bf16', bf)):
        f = build_reparam_forward(d.model, d.offline_vocabulary,
                                  nms=dict(nms_kw, conf_threshold=0.25))
        rep_s = BATCH / _synced_ms(lambda: f(x)) * 1e3
        det_s = _img_per_s(d, canv)
        print(f'[reparam] {name} conf 0.25 bs={BATCH}, median of 10 synced '
              f'calls: reparam + NMS {rep_s:.1f} img/s (float canvases on '
              f'the card), detect_batch {det_s:.1f} img/s (uint8 640x640 '
              f'frames on the card)  [{card}]')
    return launches


def _png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG with the standard library (zlib + struct)."""
    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))
    h, w = img.shape[:2]
    rows = b''.join(b'\x00' + img[y].tobytes() for y in range(h))
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows)) + chunk(b'IEND', b''))


def phase_http_cli(sdet, vocab_path, tmp: str) -> None:
    """The HTTP front end over an fp32 conf -1.0 server, then the CLIs."""
    from http.server import ThreadingHTTPServer

    from yoloclip_tpu_torch.cli.serve import decode_image_bytes, make_handler
    from yoloclip_tpu_torch.inference.server import DetectionServer
    srv = DetectionServer(sdet, max_batch=BATCH, max_delay_ms=5.0)
    frame = _mixed_frames(60, 2)[1]          # 720x1280
    png = _png(frame)
    try:
        decoded = decode_image_bytes(png)
    except ImportError:
        decoded = None
    if decoded is None:
        print('[http] no PNG decoder on this machine (no libpng headers, no '
              'PIL): POST /detect was not run')
    else:
        require(np.array_equal(decoded, frame), 'PNG decode')
    httpd = ThreadingHTTPServer(('127.0.0.1', 0), make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'

    def call(path, data=None):
        req = urllib.request.Request(url + path, data=data,
                                     method='POST' if data else 'GET')
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        if decoded is not None:
            code, body = call('/detect', png)
            want = srv.detect(frame, timeout=60)
            require(code == 200 and want
                    and body['detections'] == want, f'POST /detect: {code}')
            print(f'[http] POST /detect (stdlib PNG, 720x1280): 200, '
                  f'{len(want)} detections, equal to DetectionServer.detect')
        code, body = call('/vocab', json.dumps(
            {'class_names': ['tree', 'rock', 'pond']}).encode())
        require(code == 200 and body['classes'] == 3, 'POST /vocab')
        if decoded is not None:
            code, body = call('/detect', png)
            require(code == 200 and all(
                d['class_name'] in ('tree', 'rock', 'pond')
                for d in body['detections']), 'detect after /vocab')
        code_bad, _ = call('/detect', b'not an image')
        code_s, stats = call('/stats')
        code_h, health = call('/healthz')
        require(code_bad == 400 and code_s == 200 and code_h == 200
                and health == {'status': 'ok'} and 'requests' in stats,
                'GET /stats, /healthz, bad POST')
        print(f'[http] POST /vocab 200 (3 classes), bad image 400, GET '
              f'/stats 200 ({stats["requests"]} requests), /healthz 200')
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()

    img_path = os.path.join(tmp, 'frame.png')
    with open(img_path, 'wb') as f:
        f.write(png)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    cmds = {
        'cli.detect': ['yoloclip_tpu_torch.cli.detect', '--input', img_path,
                       '--vocab', vocab_path, '--output',
                       os.path.join(tmp, 'dets'), '--coco-json',
                       os.path.join(tmp, 'dets.json')],
        'cli.stream': ['yoloclip_tpu_torch.cli.stream', '--streams', '2',
                       '--steps', '3'],
        'cli.warmup': ['yoloclip_tpu_torch.cli.warmup'],
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, '-m', *argv], env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, argv in cmds.items()}
    for name, p in procs.items():
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        last = [ln for ln in out.splitlines() if ln.strip()][-2:]
        print(f'[cli] python -m yoloclip_tpu_torch.{name}: exit '
              f'{p.returncode}; ' + ' | '.join(last))
        require(p.returncode == 0, f'{name} failed:\n{out[-3000:]}')
    with open(os.path.join(tmp, 'dets.json')) as f:
        entries = json.load(f)
    print(f'[cli] the three CLIs ran in parallel in '
          f'{time.perf_counter() - t0:.1f} s; cli.detect wrote '
          f'{len(entries)} COCO results entries')


def phases_serving(sim, nms, det, bf, vocab_path, tmp, card) -> list:
    """Phases 10-15 (det, bf: the main path's fp32 and bf16 detectors).
    Returns the launches of each path that ran kernels."""
    phase_native(det, card)
    sdet, canvas_launches = phase_canvas(sim, nms, vocab_path)
    bdet = _detector(vocab_path, 'bfloat16', host_preprocess='auto')
    paths = [canvas_launches, phase_server(sim, nms, sdet, bdet, card),
             phase_streaming(sim, nms, sdet, bdet, card),
             phase_reparam(sim, nms, sdet, det, bf, card)]
    phase_http_cli(sdet, vocab_path, tmp)
    return paths



# ---------------------------------------------------------------------------
# int8 deploy: the int8 conv kernel against its plain version, the W8A8
# path at full width, the space-to-depth stems.
# ---------------------------------------------------------------------------

INT8_TC = 1979e12           # H100 SXM dense int8 tensor-core peak, op/s
INT8_BLOCKS = 22            # int8 blocks of the deploy graph at variant 'n'
INT8_CALIB = 8              # calibration frames
# The fused output against the plain version: the pre-SiLU values are
# bit-identical (same roundings), so only expf's last ulps and the final
# cast differ: fp32 1e-6 relative; bf16 one bf16 ulp (2^-7 relative).
INT8_TOL = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2.0 ** -7, 1e-6)}
# int8 model, card against CPU on the same quantized state. The int8 sums
# are exact on both, but where the float layers' roundoff moves an input
# across a .5 quantization boundary the two round it to neighbouring int8
# values, and such flips cascade through consecutive int8 blocks (a flip
# moves 9 x Cout outputs by a quantum times a weight). So the gate forces
# every int8 block's CPU input to the card's: each block's output then
# agrees within INT8_TOL, the whole model within the float XDEV
# tolerances; the free-running difference and its flips are printed.
# The stems against the plain stem, the JAX package's tolerances
# (tests/test_quantize.py: s2d exact up to fp32 reassociation; the u8
# canvas up to the /255 fold's rounding); ids exact outside near-ties.
STEM_TOL = {'stem_s2d': dict(box=(1e-5, 1e-5), score=(1e-5, 1e-5)),
            'stem_u8_s2d': dict(box=(1e-4, 1e-4), score=(1e-4, 1e-5))}
STEM_TIE_GAP = 1e-5
# Extra kernel cases beyond the deploy graph's shapes: (tag, B, Cin, Cout,
# H, W, stride, operands). Cin = 80 (variant 'x'; its last 32-channel
# chunk half padded) and Cin = 16 (a single half chunk), one image, a
# ragged 21 x 13 map, a 1 x 1 map, maps narrower or shorter than the
# kernel's 8 x 16 output tile at both strides, Cout = 8 (one column
# group) and 136 (past a 128-channel pass), a 160 x 160 map, operands
# all at +-127 so the accumulator reaches 9 Cin 127^2 (37.2 M at
# Cin = 256), and inputs on and within 3 ulps of the rounding boundaries
# (m + 1/2) act_scale, where the kernel's quotient must round as IEEE
# division does.
INT8_EXTRA = [('x cin80 s1', 4, 80, 160, 160, 160, 1, 'random'),
              ('x cin80 s2', 4, 80, 160, 160, 160, 2, 'random'),
              ('B=1', 1, 256, 256, 80, 80, 1, 'random'),
              ('ragged 21x13 s1', 3, 128, 256, 21, 13, 1, 'random'),
              ('ragged 21x13 s2', 3, 128, 256, 21, 13, 2, 'random'),
              ('+-127 cin256', 2, 256, 256, 20, 20, 1, '+-127'),
              ('+-127 cin80', 2, 80, 160, 20, 20, 2, '+-127'),
              ('1x1 s1', 2, 64, 128, 1, 1, 1, 'random'),
              ('1x1 s2', 2, 64, 128, 1, 1, 2, 'random'),
              ('narrow 40x3 s1', 2, 128, 256, 40, 3, 1, 'random'),
              ('narrow 40x3 s2', 2, 128, 256, 40, 3, 2, 'random'),
              ('short 3x40 s1', 2, 128, 256, 3, 40, 1, 'random'),
              ('short 3x40 s2', 2, 128, 256, 3, 40, 2, 'random'),
              ('cin16 s1', 3, 16, 64, 24, 24, 1, 'random'),
              ('cin16 s2', 3, 16, 64, 24, 24, 2, 'random'),
              ('cout8 s1', 2, 64, 8, 20, 20, 1, 'random'),
              ('cout136 s2', 2, 96, 136, 30, 30, 2, 'random'),
              ('map 160x160', 4, 64, 128, 160, 160, 1, 'random'),
              ('ties s1', 4, 256, 256, 40, 40, 1, 'ties'),
              ('ties s2', 4, 80, 136, 41, 27, 2, 'ties')]


def eligible_shapes(size: int = 640, B: int = BATCH) -> list:
    """(name, B, Cin, Cout, H, W, stride) of every int8 block of the deploy
    graph at variant 'n' and `size` px: read by forward hooks on a 64-px
    CPU run of the int8 model, scaled by size / 64."""
    from yoloclip_tpu_torch.config import ModelConfig
    from yoloclip_tpu_torch.models.layers import ConvBlock
    from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP
    m = YOLOCLIP(ModelConfig(image_size=(64, 64), quant='int8')).eval()
    shapes = []

    def hook(name):
        def rec(mod, args):
            _, c, h, w = args[0].shape
            shapes.append((name, B, c, mod.wq.shape[0], h * size // 64,
                           w * size // 64, mod.stride))
        return rec
    hooks = [mod.register_forward_pre_hook(hook(n))
             for n, mod in m.named_modules()
             if isinstance(mod, ConvBlock) and mod.mode == 'int8']
    with torch.inference_mode():
        m(torch.rand(1, 64, 64, 3), torch.randn(4, EMBED))
    for h in hooks:
        h.remove()
    return shapes


def _int8_operands(g, B, cin, cout, H, W, dtype, kind='random'):
    """x (B, Cin, H, W) channels_last in `dtype`, reaching +-amax so that
    the quantized operand hits +-127; random int8 wq over [-127, 127];
    scales and bias. kind '+-127': every input at +amax and every weight
    at +127 (first half of the channels) or -127; 'ties': every input
    (m + 1/2) act_scale for a random m in [-128, 127], moved by -3 to 3
    ulps."""
    amax = 3.0
    act = torch.tensor(amax / 127.0, device='cuda')
    if kind == 'ties':
        m = torch.randint(-128, 128, (B, cin, H, W), device='cuda',
                          generator=g).float()
        x = (m + 0.5) * act
        for _ in range(3):
            step = torch.randint(-1, 2, x.shape, device='cuda', generator=g)
            x = torch.where(step > 0, torch.nextafter(x, x + 1),
                            torch.where(step < 0, torch.nextafter(x, x - 1),
                                        x))
        wq = torch.randint(-127, 128, (cout, 3, 3, cin), dtype=torch.int8,
                           device='cuda', generator=g)
    elif kind == '+-127':
        x = torch.full((B, cin, H, W), amax, device='cuda')
        wq = torch.full((cout, 3, 3, cin), 127, dtype=torch.int8,
                        device='cuda')
        wq[cout // 2:] = -127
    else:
        x = torch.randn(B, cin, H, W, device='cuda', generator=g)
        x = x * (amax / x.abs().max())
        x[0, 0, 0, 0], x[-1, -1, -1, -1] = amax, -amax
        wq = torch.randint(-127, 128, (cout, 3, 3, cin), dtype=torch.int8,
                           device='cuda', generator=g)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    wscale = 1e-3 + 1e-2 * torch.rand(cout, device='cuda', generator=g)
    qbias = 0.1 * torch.randn(cout, device='cuda', generator=g)
    return x, wq, wscale, qbias, act


def phase_int8_kernel(i8, shapes) -> dict:
    """The int8 conv against its plain version, fp32 and bf16 input, at
    every deploy-graph shape (bs=32) and INT8_EXTRA: the int32
    accumulator bit for bit, the fused output within INT8_TOL. Returns
    the worst fused difference per input type."""
    g = torch.Generator(device='cuda').manual_seed(7)
    cases = [(n, B, ci, co, H, W, st, 'random')
             for n, B, ci, co, H, W, st in shapes] + INT8_EXTRA
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype], lines = 0.0, []
        for tag, B, ci, co, H, W, st, kind in cases:
            x, wq, ws, qb, act = _int8_operands(g, B, ci, co, H, W, dtype,
                                                kind)
            acc = i8.int8_conv(x, wq, ws, qb, act, st, epilogue=False)
            want_acc = i8.int8_conv_plain(x, wq, ws, qb, act, st,
                                          epilogue=False)
            torch.cuda.synchronize()
            require(acc.shape == want_acc.shape
                    and torch.equal(acc, want_acc),
                    f'int8 conv {tag} {str(dtype)[6:]}: the int32 '
                    f'accumulator differs from the plain version in '
                    f'{int((acc != want_acc).sum())} places')
            y = i8.int8_conv(x, wq, ws, qb, act, st).float()
            want = i8.int8_conv_plain(x, wq, ws, qb, act, st).float()
            rel, atol = INT8_TOL[dtype]
            err = (y - want).abs()
            require(bool((err <= rel * want.abs() + atol).all()),
                    f'int8 conv {tag} {str(dtype)[6:]}: fused output off '
                    f'by {err.max().item():.3e}')
            worst[dtype] = max(worst[dtype], err.max().item())
            lines.append(f'{tag} B={B} {ci}->{co} {H}x{W} s{st} '
                         f'max|acc|={int(acc.abs().max())} '
                         f'err={err.max().item():.2e}')
            del x, wq, acc, want_acc, y, want
        print(f'[int8] kernel vs plain, {str(dtype)[6:]} input, {len(cases)}'
              f' cases: int32 accumulators bit-identical in all; fused '
              f'output worst |diff| {worst[dtype]:.3e} (tol {rel:g} rel + '
              f'{atol:g}): ' + '; '.join(lines))
    return worst


def _int_mm_conv(q16, w2t, stride):
    """The conv of quantized operands as PyTorch calls: im2col (F.unfold,
    fp16 carrying the int8 values exactly) then torch._int_mm (cuBLASLt
    s8 x s8 -> s32). The yardstick of `library_ms`; the port never calls
    it."""
    return torch._int_mm(_im2col(q16, stride), w2t)


def _im2col(q16, stride):
    """The (B Ho Wo, 9 Cin) int8 im2col operand of `_int_mm_conv`."""
    B = q16.shape[0]
    cols = F.unfold(q16, 3, padding=1, stride=stride)         # (B, 9C, L)
    return cols.transpose(1, 2).reshape(B * cols.shape[2], -1).to(
        torch.int8)


def time_int8(i8, shapes, card: str) -> dict:
    """Each deploy-graph int8 block at bs=32 through the wrapper and alone
    (CUDA-graph replay: the wrapper's host work hides the small blocks'
    device time), beside its plain version, its bound, the im2col +
    torch._int_mm yardstick, torch._int_mm alone on the prebuilt im2col
    operand (cuBLASLt's tensor-core time for the same products, without
    the im2col copy) and cuDNN's bf16 conv of the same shape. Returns, per
    input type, the sums over the blocks (one forward): (ms, alone ms,
    plain ms, bound ms, bound_by, library ms)."""
    g = torch.Generator(device='cuda').manual_seed(8)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = {'ms': 0.0, 'alone': 0.0, 'plain': 0.0, 'bound': 0.0,
               'lib': 0.0, 'mm': 0.0, 'cudnn': 0.0, 'ops': 0.0, 'bytes': 0.0}
        for name, B, ci, co, H, W, st in shapes:
            x, wq, ws, qb, act = _int8_operands(g, B, ci, co, H, W, dtype)
            ms = cuda_ms(lambda: i8.int8_conv(x, wq, ws, qb, act, st))
            alone = graph_ms(lambda: i8.int8_conv(x, wq, ws, qb, act, st))
            plain = cuda_ms(lambda: i8.int8_conv_plain(x, wq, ws, qb, act,
                                                       st), iters=3,
                            warmup=1)
            q16 = i8.quantize_plain(x, act).half()
            w2t = wq.permute(0, 3, 1, 2).reshape(co, -1).contiguous().t()
            acc = i8.int8_conv(x, wq, ws, qb, act, st, epilogue=False)
            require(torch.equal(_int_mm_conv(q16, w2t, st),
                                acc.permute(0, 2, 3, 1).reshape(-1, co)),
                    f'{name}: im2col + torch._int_mm disagrees')
            lib = cuda_ms(lambda: _int_mm_conv(q16, w2t, st), iters=10)
            cols = _im2col(q16, st)
            mm = cuda_ms(lambda: torch._int_mm(cols, w2t), iters=10)
            xb = x.bfloat16()
            wb = wq.permute(0, 3, 1, 2).bfloat16().contiguous(
                memory_format=torch.channels_last)
            cudnn = cuda_ms(lambda: F.conv2d(xb, wb, None, st, 1), iters=10)
            Ho, Wo = (H - 1) // st + 1, (W - 1) // st + 1
            esize = torch.finfo(dtype).bits // 8
            ops = 2 * B * Ho * Wo * co * 9 * ci
            nbytes = (B * H * W * ci * esize + co * 9 * ci
                      + B * Ho * Wo * co * esize + 8 * co + 4)
            bms, bby = bound(ops, nbytes, INT8_TC)
            for k, v in (('ms', ms), ('alone', alone), ('plain', plain),
                         ('bound', bms),
                         ('lib', lib), ('mm', mm), ('cudnn', cudnn),
                         ('ops', ops), ('bytes', nbytes)):
                tot[k] += v
            print(f'[time] int8 conv {str(dtype)[6:]} {name} B={B} '
                  f'{ci}->{co} {H}x{W} s{st}: kernel {ms:.4f} ms (alone '
                  f'{alone:.4f}), plain '
                  f'{plain:.4f}, im2col + _int_mm {lib:.4f}, _int_mm alone '
                  f'{mm:.4f}, cuDNN bf16 conv {cudnn:.4f}, bound {bms:.4f} '
                  f'({bby}; {ops / 1e9:.1f} GOP), {bms / ms:.0%} of bound '
                  f'({bms / alone:.0%} alone)  '
                  f'[{card}]')
            del x, wq, q16, w2t, acc, xb, wb, cols
        bms, bby = bound(tot['ops'], tot['bytes'], INT8_TC)
        print(f'[time] int8 conv {str(dtype)[6:]}, all {len(shapes)} blocks '
              f'of one bs={BATCH} forward: kernel {tot["ms"]:.4f} ms (alone '
              f'{tot["alone"]:.4f}), plain '
              f'{tot["plain"]:.4f}, im2col + _int_mm {tot["lib"]:.4f}, '
              f'_int_mm alone {tot["mm"]:.4f}, cuDNN bf16 conv '
              f'{tot["cudnn"]:.4f}, bound {tot["bound"]:.4f}'
              f' (sum of per-block bounds; {tot["ops"] / 1e9:.1f} GOP, '
              f'{tot["bytes"] / 1e6:.1f} MB: {bby}-bound in all), '
              f'{tot["bound"] / tot["ms"]:.0%} of bound ('
              f'{tot["bound"] / tot["alone"]:.0%} alone)  [{card}]')
        res[dtype] = (tot['ms'], tot['alone'], tot['plain'], tot['bound'],
                      bby, tot['lib'])
    return res


def _int8_counts(sim, nms, i8) -> dict:
    return dict(_counts(sim, nms), int8_conv=i8.launches - i8.launches_bf16,
                int8_conv_bf16=i8.launches_bf16)


def _zero_int8(sim, nms, i8) -> None:
    _zero_counts(sim, nms)
    i8.launches = i8.launches_bf16 = i8.launches_s8 = 0


def _int8_card_vs_cpu(card_model, cpu_model, x, text):
    """The int8 model on the card (fused scoring) and on the CPU on the
    same input, twice on the CPU: free-running, and with every int8
    block's input and every int8-stored edge forced to the card's (forward
    pre-hooks and hooks). Returns (rounding flips at the int8 blocks'
    inputs and the stored edges when free-running, int8 values in all,
    the worst relative difference of an int8 block's output given the
    same input, card output, free CPU output, forced CPU output)."""
    from yoloclip_tpu_torch.models.layers import QT, ConvBlock
    from yoloclip_tpu_torch.ops.kernels.int8_conv import quantize_plain
    ins, outs, edges = {}, {}, {}

    def host(t):
        return (QT(t.q.cpu(), t.scale.cpu(), t.dtype) if isinstance(t, QT)
                else t.cpu())

    def record(side):
        def rec(mod, args, out):
            ins.setdefault(side, {})[mod.name] = host(args[0])
            outs.setdefault(side, {})[mod.name] = out.cpu()
        return rec

    def record_edge(side):
        def rec(mod, args, out):
            if isinstance(out, QT):
                edges.setdefault(side, {})[mod.name] = host(out)
        return rec

    def force(mod, args):
        return (ins['card'][mod.name],)

    def force_edge(mod, args, out):
        return edges.get('card', {}).get(mod.name)

    blocks, stores = {}, {}
    for side, model in (('card', card_model), ('cpu', cpu_model)):
        named = [(n, m) for n, m in model.named_modules()
                 if isinstance(m, ConvBlock)]
        blocks[side] = [(n, m) for n, m in named if m.mode == 'int8']
        stores[side] = [(n, m) for n, m in named
                        if m.store_out and m.mode == 'folded']
        for n, m in named:
            m.name = n
    with torch.inference_mode():
        hooks = [m.register_forward_hook(record('card'))
                 for _, m in blocks['card']]
        hooks += [m.register_forward_hook(record_edge('card'))
                  for _, m in stores['card']]
        got = card_model(x, text.cuda(), fused_scores=True)
        for h in hooks:
            h.remove()
        hooks = [m.register_forward_hook(record('free'))
                 for _, m in blocks['cpu']]
        hooks += [m.register_forward_hook(record_edge('free'))
                  for _, m in stores['cpu']]
        free = cpu_model(x.cpu(), text.cpu())
        for h in hooks:
            h.remove()
        hooks = [m.register_forward_pre_hook(force) for _, m in blocks['cpu']]
        hooks += [m.register_forward_hook(record('forced'))
                  for _, m in blocks['cpu']]
        hooks += [m.register_forward_hook(force_edge)
                  for _, m in stores['cpu']]
        forced = cpu_model(x.cpu(), text.cpu())
        for h in hooks:
            h.remove()
    flips = total = 0
    worst = 0.0
    pairs = [(edges.get('card', {})[n].q, edges['free'][n].q)
             for n in edges.get('free', {})]
    for n, m in blocks['cpu']:
        a, f = ins['card'][n], ins['free'][n]
        if not isinstance(a, QT):     # a stored edge is counted above
            pairs.append((quantize_plain(a, m.act_scale),
                          quantize_plain(f, m.act_scale)))
        want = outs['forced'][n]
        # |diff| <= rel |want| + atol with rel = atol: |diff| / (|want| + 1)
        worst = max(worst, ((outs['card'][n].float() - want.float()).abs()
                            / (want.float().abs() + 1)).max().item())
    for a, f in pairs:
        flips += int((a != f).sum())
        total += a.numel()
    return flips, total, worst, got, free, forced


def _kernels_per_forward(model, x, text) -> str:
    """CUDA kernels one fused-scoring forward launches, in all and inside
    the ConvBlocks, from torch.profiler's device records (or 'not
    measured' where the profiler shows none)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from yoloclip_tpu_torch.models.layers import ConvBlock
    hooks = []
    for m in model.modules():
        if isinstance(m, ConvBlock):
            ctx = {}
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, ctx=ctx: ctx.update(
                    r=record_function('convblock').__enter__())))
            hooks.append(m.register_forward_hook(
                lambda mod, a, o, ctx=ctx: ctx['r'].__exit__(None, None,
                                                             None)))
    with torch.inference_mode():
        model(x, text, fused_scores=True)        # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x, text, fused_scores=True)
            torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return 'not measured (the profiler recorded no device event)'

    def in_block(e):
        while e is not None:
            if e.name == 'convblock':
                return True
            e = e.cpu_parent
        return False
    n_in = sum(len(e.kernels) for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.kernels and in_block(e))
    return (f'{len(device)} device activities in all, {n_in} attributed to '
            f'the ConvBlocks')


def phase_int8_path(sim, nms, i8, det, bf, vocab_path, frames, card):
    """The W8A8 path at variant 'n', 640 px, COCO-80, quantize_int8 on
    INT8_CALIB seeded frames; bf16 and fp32 detect_batch at bs=32 (22
    launches a forward), card vs CPU at bs=2 on the same quantized state,
    img/s beside the float detectors (det, bf), stage times, a server.
    Returns the launches of the path and the bf16 int8 detector."""
    from yoloclip_tpu_torch.inference.server import DetectionServer
    from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch
    rng = np.random.RandomState(70)
    calib = torch.from_numpy(rng.randint(
        0, 256, (INT8_CALIB, 480, 640, 3), dtype=np.uint8)).cuda()
    q32 = _detector(vocab_path, host_preprocess='auto')
    qbf = _detector(vocab_path, 'bfloat16')
    secs = []
    for d in (q32, qbf):
        t0 = time.perf_counter()
        d.quantize_int8(calib)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print(f'[int8] quantize_int8 on {INT8_CALIB} seeded 480x640 frames '
          f'(calibration forward + BN fold + quantize on the host): fp32 '
          f'{secs[0]:.2f} s, bf16 {secs[1]:.2f} s  [{card}]')

    _zero_int8(sim, nms, i8)
    out_bf = qbf.detect_batch(frames)
    torch.cuda.synchronize()
    per_bf = i8.launches_bf16
    out_32 = q32.detect_batch(frames)
    torch.cuda.synchronize()
    launches = _int8_counts(sim, nms, i8)
    print(f'[int8] bf16 then fp32 detect_batch bs={BATCH}: launches '
          f'{launches} (int8 conv a bf16 forward: {per_bf})')
    require(per_bf == INT8_BLOCKS and launches['int8_conv'] == INT8_BLOCKS,
            f'int8 conv launched {per_bf} / {launches["int8_conv"]} times '
            f'a forward, not {INT8_BLOCKS}')
    require(launches['similarity'] > 0 and launches['similarity_bf16'] > 0
            and launches['nms'] > 0, 'int8 path: kernels 1 and 2')
    for name, o in (('bf16', out_bf), ('fp32', out_32)):
        require(_finite(o) and o['boxes'].shape[0] == BATCH,
                f'int8 {name} detect_batch output')

    # card vs CPU on the same quantized state, bs=2, fp32
    cpu = YOLOCLIP(q32.model.cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in
                         q32.model.state_dict().items()})
    with torch.inference_mode():
        canv, _ = letterbox_batch(frames[:2], q32.image_size)
    flips, total, worst, got, free, want = _int8_card_vs_cpu(
        q32.model, cpu, canv, q32.offline_vocabulary)
    top2 = want['similarity'].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP
    s_err = (got['scores'].cpu() - want['scores']).abs().max().item()
    bad = int(((got['class_ids'].cpu() != want['class_ids']) & ~tie).sum())
    gb, wb = got['boxes'].cpu(), want['boxes']
    box_ok = torch.allclose(gb, wb, rtol=XDEV_BOX_RTOL, atol=XDEV_BOX_ATOL)
    f_err = (got['scores'].cpu() - free['scores']).abs()
    f_box = ((gb - free['boxes']).abs() / free['boxes'].abs().clamp_min(1))
    print(f'[int8] bs=2 fp32 card vs CPU, same quantized state, every int8 '
          f'block\'s input forced to the card\'s: int8 block outputs within '
          f'{worst:.2e} relative (tol {INT8_TOL[torch.float32][0]:g}); '
          f'max|score diff|={s_err:.3e} (tol {XDEV_SCORE_ATOL:g}), id '
          f'mismatches outside near-ties={bad}, boxes within rtol '
          f'{XDEV_BOX_RTOL:g} atol {XDEV_BOX_ATOL:g}={box_ok}. Free-running '
          f'(not gated): {flips} of {total} int8 inputs ({flips / total:.2e})'
          f' round to a neighbouring value, max|score diff| '
          f'{f_err.max().item():.3e} (median {f_err.median().item():.2e}), '
          f'box rel err max {f_box.max().item():.2e}')
    require(worst <= INT8_TOL[torch.float32][0] and s_err <= XDEV_SCORE_ATOL
            and bad == 0 and box_ok, 'int8 model: card and CPU disagree')
    del cpu, got, want, free

    # throughput beside the float detectors, in turns
    rates = {}
    for eager in (True, False):
        for name, d in (('float fp32', det), ('int8 fp32', q32),
                        ('int8 bf16', qbf), ('float bf16', bf)):
            rates[f'{name} {"eager" if eager else "program"}'] = _img_per_s(
                d, frames, eager=eager)
    print(f'[time] detect_batch bs={BATCH} 640px COCO-80, median of 10 '
          f'synced calls, in this order: ' + ', '.join(
              f'{k} {v:.1f} img/s' for k, v in rates.items())
          + f'  [{card}]')
    with torch.inference_mode():
        canv, _ = letterbox_batch(frames[:2], q32.image_size)
    for name, d in (('float fp32', det), ('float bf16', bf),
                    ('int8 fp32', q32), ('int8 bf16', qbf)):
        print(f'[int8] CUDA kernels of one bs=2 forward, {name}: '
              f'{_kernels_per_forward(d.model, canv, d.offline_vocabulary)}')
    for name, d in (('int8 fp32', q32), ('int8 bf16', qbf)):
        ms = _stage_ms(d, frames, sim)
        print(f'[stages] {name}, bs={BATCH}, 640 px, device ms of each '
              f'stage alone: ' + ', '.join(f'{k} {v:.3f}'
                                            for k, v in ms.items())
              + f'  [{card}]')

    # the server with the int8 detector: 8 mixed requests vs detect()
    q32.conf_threshold = -1.0
    reqs = _mixed_frames(71, 8)
    _zero_int8(sim, nms, i8)
    with DetectionServer(q32, max_batch=BATCH, max_delay_ms=300.0) as srv:
        futs = [srv.submit(f) for f in reqs]
        served = [f.result(timeout=120) for f in futs]
    torch.cuda.synchronize()
    srv_launches = _int8_counts(sim, nms, i8)
    require(srv_launches['int8_conv'] == INT8_BLOCKS,
            f'int8 server batch: {srv_launches}')
    # the served detections are the canvas program's on the same batch
    from yoloclip_tpu_torch.inference.detector import _unpack_detections
    lbs = [q32._host_letterbox(f) for f in reqs]
    canvases = [c for c, _ in lbs]
    packed = q32._detect_canvases(
        torch.from_numpy(np.stack(canvases)).cuda(), q32.offline_vocabulary,
        torch.tensor([sc for _, sc in lbs], device='cuda'),
        torch.tensor([[f.shape[1], f.shape[0]] for f in reqs],
                     dtype=torch.float32, device='cuda')).cpu().numpy()
    require(all(g_ == _unpack_detections(packed[i], q32.class_names)[0]
                for i, g_ in enumerate(served)),
            'int8 server: detections differ from the canvas program on the '
            'same batch')
    batch_scores, _, _ = _pre_nms_scores(q32, canvases)
    single = [_pre_nms_scores(q32, [c])[0][0] for c in canvases]
    delta = max((batch_scores[i] - single[i]).abs().max().item()
                for i in range(len(reqs)))
    # int8 rounding flips between the batch and a single frame can move a
    # score by more than float noise: the measured delta bounds it
    compared = [_check_detections(f'int8 server request {i}', g_, w_,
                                  single[i], delta, q32.config.nms_topk,
                                  max(XDEV_SCORE_ATOL, delta))
                for i, (g_, w_) in enumerate(
                    zip(served, [q32.detect(f) for f in reqs]))]
    print(f'[int8] server, fp32 int8 detector, conf -1.0: 8 mixed requests '
          f'in one batch: identical to the canvas program on the same batch;'
          f' vs detect() on each frame: pre-NMS max|score diff| batch vs '
          f'single={delta:.3e} (int8 rounding flips), detections compared '
          f'(above the first possible order flip) / kept: {compared}; '
          f'launches {srv_launches}')
    return {k: launches[k] + srv_launches[k] for k in launches}, qbf


# ---------------------------------------------------------------------------
# [graphs]: the per-shape programs (inference/program.py)
# ---------------------------------------------------------------------------

# A program's replay against its eager body: the same kernels on the same
# inputs in the same order, so bit-equal is expected; above this it fails.
GRAPH_ATOL = 1e-6
GRAPH_CALLS = 3          # program calls counted against the eager counts
GRAPH_TRACED = 5         # calls a span in the eager / program trace
GRAPH_SERVE_PER = 16     # requests a client in the serving A/B


def _graph_diff(tag, got, want) -> float:
    """A program's batched NMS dict against the eager body's: counts,
    validity, saturation and class ids exact; the max |diff| of scores
    and boxes, which fails above GRAPH_ATOL."""
    for k in ('count', 'valid', 'prefilter_saturated', 'class_ids'):
        require(torch.equal(got[k], want[k]), f'[graphs] {tag}: {k} differ')
    err = max((got[k].float() - want[k].float()).abs().max().item()
              for k in ('scores', 'boxes'))
    require(err <= GRAPH_ATOL,
            f'[graphs] {tag}: max|diff| {err:.3e} > {GRAPH_ATOL:g}')
    return err


def _same_lists(tag, got, want) -> None:
    """Detection lists of a program and of its eager body: ids exact,
    scores within GRAPH_ATOL, int boxes within 1 px."""
    require(len(got) == len(want), f'[graphs] {tag}: {len(got)} vs '
            f'{len(want)} detections')
    for a, b in zip(got, want):
        require(a['class_id'] == b['class_id']
                and abs(a['score'] - b['score']) <= GRAPH_ATOL
                and max(abs(p - q) for p, q in zip(a['box'], b['box'])) <= 1,
                f'[graphs] {tag}: {a} vs {b}')


class _EagerPrograms:
    """Stands in for a server's ProgramCache: each body runs eagerly on
    its inputs moved to the device (the server as it ran before the
    programs), for the serving A/B."""

    def run(self, name, key, body, inputs, device):
        return body(*(x.to(device, non_blocking=True) for x in inputs))


def _serve_ab(srv, pool) -> tuple:
    """SERVE_CLIENTS closed-loop clients x GRAPH_SERVE_PER mixed frames:
    (requests/s, p50 ms, p95 ms)."""
    srv.reset_stats()
    errors = []

    def client(c):
        try:
            for i in range(GRAPH_SERVE_PER):
                srv.detect(pool[(c * GRAPH_SERVE_PER + i) % len(pool)],
                           timeout=120)
        except Exception as e:            # reported below, fails the run
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    st = srv.stats()
    n = SERVE_CLIENTS * GRAPH_SERVE_PER
    require(not errors and st['requests'] == n,
            f'[graphs] serving: {errors[:1]} {st}')
    return n / wall, st['p50_latency_ms'], st['p95_latency_ms']


def _dispatch_ms(srv, bdet, pool) -> float:
    """Median synced ms of one full bf16 batch through the server's
    dispatch step (assemble, upload, canvas program, download)."""
    from yoloclip_tpu_torch.inference.server import _Request
    reqs = []
    for f in (pool * 2)[:BATCH]:
        canvas, scale = bdet._host_letterbox(f)
        reqs.append(_Request(canvas, scale, np.asarray(
            [f.shape[1], f.shape[0]], np.float32), [], None))

    def dispatch():
        with torch.inference_mode():
            _, done = srv._launch(reqs, BATCH, bdet.offline_vocabulary)
        for ev in done:
            ev.synchronize()
    return _synced_ms(dispatch)


# Each hand kernel's device event (a substring of its demangled name); an
# NMS launch runs two, the mask build and the scan
HAND_KERNELS = ('similarity_wgmma', 'nms_mask', 'nms_scan', 'int8_conv_wgmma')
# calls of each of two threads at once on one graph pool
POOL_CALLS = 16


def _hand_counts(sim, nms, i8) -> dict:
    """The hand kernels' launch counters, as device events count them."""
    return {'similarity_wgmma': sim.launches + sim.unprojected_launches,
            'nms_mask': nms.launches, 'nms_scan': nms.launches,
            'int8_conv_wgmma': i8.launches}


def _hand_events(kernels: dict) -> dict:
    """The device events of each hand kernel in `device_summary`'s
    kernels."""
    return {k: sum(n for name, (_, n) in kernels.items() if k in name)
            for k in HAND_KERNELS}


def _shared_pool_threads(det, srv, frames, pool) -> None:
    """Two threads at once on one device's graph pool, started together:
    one calls det.detect_batch(frames) (its program), the other the
    server's warmed BATCH-bucket program on BATCH mixed canvases,
    POOL_CALLS each, neither waiting for the device. Every result must
    equal its eager body's on the same inputs: a replay queued between
    another program's replay and its clone-out would hand that caller
    memory the other program wrote."""
    text = det.offline_vocabulary
    want_batch = det._detect_batch_eager(frames, text)
    canv, meta = [], []
    for f in (pool * 2)[:BATCH]:
        canvas, scale = det._host_letterbox(f)
        canv.append(canvas)
        meta.append([scale, f.shape[1], f.shape[0]])
    canv = torch.from_numpy(np.stack(canv)).pin_memory()
    meta = torch.tensor(meta, dtype=torch.float32).pin_memory()
    m = meta.cuda()
    want_srv = det._detect_canvases(canv.cuda(), text, m[:, 0], m[:, 1:])
    bucket = next(p for p in srv.programs.programs()
                  if p.name == 'bucket' and p.static[0].shape[0] == BATCH)
    start = threading.Barrier(2)
    got_batch, got_srv, errors = [], [], []

    def calls(fn, out):
        try:
            start.wait(timeout=60)
            for _ in range(POOL_CALLS):
                out.append(fn())
        except Exception as e:            # reported below, fails the run
            errors.append(e)

    threads = [threading.Thread(target=calls, args=(
                   lambda: det.detect_batch(frames), got_batch)),
               threading.Thread(target=calls, args=(
                   lambda: bucket((canv, text, meta)), got_srv))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    require(not errors and len(got_batch) == len(got_srv) == POOL_CALLS,
            f'[graphs] two threads on one graph pool: {errors[:1]}')
    for i, got in enumerate(got_batch):
        _graph_diff(f'detect_batch on a thread, call {i}', got, want_batch)
    for i, got in enumerate(got_srv):
        err = (got - want_srv).abs().max().item()
        require(err <= GRAPH_ATOL, f'[graphs] server bucket on a thread, '
                f'call {i}: packed max|diff| {err:.3e}')


def _forced_sync_raises(grad: bool = False) -> bool:
    """A body that syncs (`.item()`) raises at capture, naming the program
    and its key; a capture after it still works. grad: both bodies run a
    backward, as a train program does (`ProgramCache.run(grad=True)`)."""
    from yoloclip_tpu_torch.inference.program import ProgramCache
    cache = ProgramCache()
    x = torch.arange(4.0, device='cuda')
    w = torch.nn.Parameter(torch.ones(4, device='cuda'))

    def synced(t):
        if grad:
            (w * t).sum().backward()
        return t * float(t.sum().item())

    def fine(t):
        if not grad:
            return t * 2
        w.grad = None
        (w * t * 2).sum().backward()
        return w.grad

    try:
        cache.run('forced sync', ('probe',), synced, (x,), x.device, grad)
    except RuntimeError as e:
        raised = "'forced sync'" in str(e) and 'probe' in str(e)
    else:
        raised = False
    for _ in range(2):                    # captured, then replayed
        after = cache.run('after', (), fine, (x,), x.device, grad)
    return raised and torch.equal(after, x * 2) and cache.count() == 1


def phase_graphs(sim, nms, i8, detectors, frames, tmp, card) -> dict:
    """[graphs]: each detector's detect_batch program (CUDA graph replay)
    against its eager body; launch counts under replay; img/s in turns;
    device ms and idle share from a trace of each; capture seconds; the
    graph pool; both detect() branches, the server's warmed buckets and
    the streaming step against their eager bodies; the serving A/B; a
    body that syncs raises at capture. detectors: (name, detector) with
    COCO-80 vocabularies. Returns the launches of the counted calls."""
    from yoloclip_tpu_torch.inference import program
    from yoloclip_tpu_torch.inference.detector import _unpack_detections
    from yoloclip_tpu_torch.inference.server import DetectionServer
    from yoloclip_tpu_torch.inference.streaming import StreamingDetector
    from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                    trace)
    t_start = time.perf_counter()
    rng = np.random.RandomState(90)
    frames2 = torch.from_numpy(rng.randint(
        0, 256, tuple(frames.shape), dtype=np.uint8)).cuda()
    total = {}
    for name, d in detectors:
        text = d.offline_vocabulary
        eager = lambda f: d._detect_batch_eager(f, text)   # noqa: E731
        d.detect_batch(frames)                 # captured if it was not
        # replays against the eager body; a held result across a call
        got = d.detect_batch(frames)
        held = {k: v.clone() for k, v in got.items()}
        err = _graph_diff(f'{name} detect_batch', got, eager(frames))
        got2 = d.detect_batch(frames2)
        err = max(err, _graph_diff(f'{name} detect_batch, other frames',
                                   got2, eager(frames2)))
        require(all(torch.equal(got[k], held[k]) for k in held),
                f'[graphs] {name}: a held result changed on the next call')
        # launches: the eager body once, then GRAPH_CALLS replays
        _zero_int8(sim, nms, i8)
        eager(frames)
        torch.cuda.synchronize()
        per_call = _int8_counts_all(sim, nms, i8)
        _zero_int8(sim, nms, i8)
        for _ in range(GRAPH_CALLS):
            d.detect_batch(frames)
        torch.cuda.synchronize()
        launches = _int8_counts_all(sim, nms, i8)
        require(launches == {k: GRAPH_CALLS * v for k, v in per_call.items()}
                and launches['nms'] == GRAPH_CALLS,
                f'[graphs] {name}: {GRAPH_CALLS} replays launched '
                f'{launches}, the eager body {per_call} a call')
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        # img/s in turns: eager, program, program, eager
        rates = [_img_per_s(d, frames, eager=e)
                 for e in (True, False, False, True)]
        # device ms a call and idle share, eager and program
        # and the hand kernels' events in the program span against the
        # counters' increments over the same calls
        log_dir = os.path.join(tmp, f'graphs_{name.replace(" ", "_")}')
        counted = {}
        with trace(log_dir) as prof:
            for tag, fn in (('eager', lambda: eager(frames)),
                            ('program', lambda: d.detect_batch(frames))):
                with annotate(f'{tag} x{GRAPH_TRACED}'):
                    before = _hand_counts(sim, nms, i8)
                    for _ in range(GRAPH_TRACED):
                        fn()
                    torch.cuda.synchronize()
                    counted[tag] = {k: v - before[k] for k, v in
                                    _hand_counts(sim, nms, i8).items()}
        summ = {tag: device_summary(prof, span=f'{tag} x{GRAPH_TRACED}')
                for tag in ('eager', 'program')}
        events = _hand_events(summ['program']['kernels'])
        require(events == counted['program']
                and events['nms_scan'] == GRAPH_TRACED,
                f'[graphs] {name}: the trace of {GRAPH_TRACED} program calls '
                f'holds the hand kernels\' events {events}, their counters '
                f'rose by {counted["program"]}')
        progs = [p for p in d.programs.programs()
                 if p.name == 'detect_batch'
                 and tuple(p.static[0].shape) == tuple(frames.shape)]
        print(f'[graphs] {name} detect_batch bs={BATCH} 640 px COCO-80, '
              f'program (CUDA graph replay) vs eager body: ids, counts, '
              f'valid, saturation exact, max|score/box diff|={err:.3e} (tol '
              f'{GRAPH_ATOL:g}); a held result unchanged; launches of '
              f'{GRAPH_CALLS} replays {launches} = {GRAPH_CALLS} x eager; '
              f'hand kernels\' events in the trace of {GRAPH_TRACED} '
              f'program calls {events} = their counters\' increments; '
              f'img/s median of 10 synced calls in turns eager '
              f'{rates[0]:.1f}, program {rates[1]:.1f}, program '
              f'{rates[2]:.1f}, eager {rates[3]:.1f}; device ms a call / '
              f'idle share eager '
              f'{summ["eager"]["busy_ms"] / GRAPH_TRACED:.3f} / '
              f'{_share(summ["eager"]["idle_share"])}, program '
              f'{summ["program"]["busy_ms"] / GRAPH_TRACED:.3f} / '
              f'{_share(summ["program"]["idle_share"])}; warm-up '
              + ', '.join(f'{p.warmup_s:.3f}' for p in progs)
              + ' s, capture ' + ', '.join(f'{p.capture_s:.3f}' for p in progs)
              + f' s  [{card}]')
    dev = torch.device('cuda', torch.cuda.current_device())

    # both detect() branches, float bf16, against their eager bodies
    _, bdet = detectors[1]
    text = bdet.offline_vocabulary
    frame = frames[0].cpu().numpy()
    bdet.detect(frame)                     # the device-letterbox program
    got = bdet.detect(frame)
    want = _unpack_detections(bdet._detect_eager(
        torch.as_tensor(frame).cuda(), text).cpu().numpy(),
        bdet.class_names)[0]
    _same_lists('detect() device letterbox', got, want)
    cfg = bdet.config
    bdet.config = dataclasses.replace(cfg, host_preprocess='auto')
    try:
        bdet.detect(frame)                 # the canvas program
        got = bdet.detect(frame)
    finally:
        bdet.config = cfg
    canvas, scale = bdet._host_letterbox(frame)
    meta = torch.tensor([[scale, frame.shape[1], frame.shape[0]]],
                        device='cuda')
    want = _unpack_detections(bdet._detect_canvases(
        torch.from_numpy(canvas)[None].cuda(), text, meta[:, 0],
        meta[:, 1:])[0].cpu().numpy(), bdet.class_names)[0]
    _same_lists('detect() canvas', got, want)

    # the server: warmed buckets vs the eager server, then the A/B
    pool = _mixed_frames(91, 24)
    srv = DetectionServer(bdet, max_batch=BATCH, max_delay_ms=300.0)
    esrv = DetectionServer(bdet, max_batch=BATCH, max_delay_ms=300.0)
    esrv.programs = _EagerPrograms()
    try:
        t0 = time.perf_counter()
        seconds = srv.warmup()
        warm_s = time.perf_counter() - t0
        reqs = pool[:8]
        got = [f.result(timeout=120) for f in [srv.submit(f) for f in reqs]]
        want = [f.result(timeout=120) for f in [esrv.submit(f) for f in reqs]]
        for i, (g, w) in enumerate(zip(got, want)):
            _same_lists(f'server request {i}', g, w)
        t0 = time.perf_counter()
        _shared_pool_threads(bdet, srv, frames, pool)
        threads_s = time.perf_counter() - t0
        for server in (srv, esrv):       # [server]'s flush delay
            server.max_delay_s = 0.005
        ab = [_serve_ab(s, pool) for s in (esrv, srv, srv, esrv)]
        disp = [_dispatch_ms(s, bdet, pool) for s in (esrv, srv, srv, esrv)]
        n_buckets = srv.programs.count('bucket')
    finally:
        srv.close()
        esrv.close()
    print(f'[graphs] server, bf16, max_batch {BATCH}: warmup() captured '
          f'{n_buckets} bucket programs in {warm_s:.2f} s (per bucket: '
          + ', '.join(f'bs={b} {t:.3f}' for b, t in seconds.items())
          + f' s); 8 mixed requests identical to the eager server\'s; '
          f'two threads at once on the device\'s graph pool, '
          f'{POOL_CALLS} detect_batch calls and {POOL_CALLS} calls of '
          f'the {BATCH}-bucket ({threads_s:.2f} s): every result equal to '
          f'its eager body\'s; '
          f'{SERVE_CLIENTS} closed-loop clients x {GRAPH_SERVE_PER} frames '
          f'(max_delay 5 ms) in turns eager, program, program, eager: '
          f'requests/s '
          + ', '.join(f'{r:.1f}' for r, _, _ in ab) + '; p50 ms '
          + ', '.join(f'{p:.2f}' for _, p, _ in ab) + '; p95 ms '
          + ', '.join(f'{p:.2f}' for _, _, p in ab)
          + f'; dispatch step of a batch of {BATCH} (assemble, upload, '
          f'canvas program, download; median of 10 synced) ms '
          + ', '.join(f'{m:.2f}' for m in disp) + f'  [{card}]')

    # the streaming step's program vs the eager step
    from yoloclip_tpu_torch.cli.stream import _synthetic_source
    sd = StreamingDetector(bdet.model, text, STREAMS, STREAM_HW, bdet.config)
    source = _synthetic_source(STREAMS, STREAM_HW)
    sd.step(source(0))                     # captured
    serr = 0.0
    for k in (1, 2):
        f = source(k)
        serr = max(serr, _graph_diff(f'streaming step {k}', sd.step(f),
                                     sd._step(torch.as_tensor(f).cuda())))
    require(sd.programs.count('step') == 1, '[graphs] one step program')
    # before the failed capture below, which retires the device's pool
    pool_gib = program.pool_bytes(dev) / 2 ** 30
    reserved_gib = torch.cuda.memory_reserved(dev) / 2 ** 30
    raised = _forced_sync_raises()
    require(raised, '[graphs] a body that syncs did not raise at capture '
            'naming its program, or a capture after it failed')
    print(f'[graphs] streaming step bf16, {STREAMS} x {STREAM_HW[0]}x'
          f'{STREAM_HW[1]}: program vs eager step max|diff|={serr:.3e}; '
          f'detect() device-letterbox and canvas programs: detections '
          f'equal to their eager bodies\'; a body calling .item() raised at '
          f'capture={raised}; graph pool on {dev}: {pool_gib:.2f} GiB (of '
          f'{reserved_gib:.2f} GiB reserved); phase seconds '
          f'{time.perf_counter() - t_start:.1f}  [{card}]')
    return total


# The int8-stored edges (models/layers.py::QT): (tag, threshold, stored
# edges, int8-input launches a forward) at variant 'n', 640 px. Off is the
# default threshold; at 819200 only stage1_csp.cv3 (32 x 160 x 160) stores,
# into a BN-folded conv; at 0 all nine do, four of them into int8 convs.
EDGE_SETTINGS = (('off', 1 << 62, 0, 0), ('1 edge', 819200, 1, 0),
                 ('9 edges', 0, 9, 4))
# The int8 convs that read an edge as int8: (B, Cin, Cout, H, W, stride)
EDGE_READER = (BATCH, 64, 128, 20, 20, 1)


@contextlib.contextmanager
def _store_threshold(value: int):
    """The port's STORE_INT8_MIN_ELEMS set to value, restored after."""
    from yoloclip_tpu_torch.models import layers
    old = layers.STORE_INT8_MIN_ELEMS
    layers.STORE_INT8_MIN_ELEMS = value
    try:
        yield
    finally:
        layers.STORE_INT8_MIN_ELEMS = old


def phase_int8_s8_kernel(i8, shapes) -> dict:
    """The int8 conv's int8-input mode against its plain version: the four
    edge readers' shape at bs=32 in fp32 and bf16 output, then every case
    of phase_int8_kernel with its quantized input, fp32 output. The int32
    accumulator bit for bit, the fused output within INT8_TOL. Returns the
    worst fused difference per output type."""
    g = torch.Generator(device='cuda').manual_seed(9)
    f32, b16 = torch.float32, torch.bfloat16
    cases = ([(f'edge reader {i}', *EDGE_READER, 'random', dt)
              for i in range(4) for dt in (f32, b16)]
             + [(n, B, ci, co, H, W, st, 'random', f32)
                for n, B, ci, co, H, W, st in shapes]
             + [(*c, f32) for c in INT8_EXTRA])
    worst = {f32: 0.0, b16: 0.0}
    for tag, B, ci, co, H, W, st, kind, dt in cases:
        x, wq, ws, qb, act = _int8_operands(g, B, ci, co, H, W, f32, kind)
        q = i8.quantize_plain(x, act)
        acc = i8.int8_conv(q, wq, ws, qb, act, st, epilogue=False,
                           out_dtype=dt)
        want_acc = i8.int8_conv_plain(q, wq, ws, qb, act, st,
                                      epilogue=False)
        torch.cuda.synchronize()
        require(acc.shape == want_acc.shape and torch.equal(acc, want_acc),
                f'int8-input conv {tag}: the int32 accumulator differs from '
                f'the plain version in {int((acc != want_acc).sum())} places')
        y = i8.int8_conv(q, wq, ws, qb, act, st, out_dtype=dt).float()
        want = i8.int8_conv_plain(q, wq, ws, qb, act, st,
                                  out_dtype=dt).float()
        rel, atol = INT8_TOL[dt]
        err = (y - want).abs()
        require(bool((err <= rel * want.abs() + atol).all()),
                f'int8-input conv {tag} {str(dt)[6:]} output: off by '
                f'{err.max().item():.3e}')
        worst[dt] = max(worst[dt], err.max().item())
        del x, q, wq, acc, want_acc, y, want
    print(f'[int8 edges] int8-input conv vs plain, {len(cases)} cases (the '
          f'edge readers {EDGE_READER[1]}->{EDGE_READER[2]} '
          f'{EDGE_READER[3]}x{EDGE_READER[4]} at bs={BATCH} in fp32 and '
          f'bf16 output, then the {len(shapes)} deploy-graph blocks and '
          f'{len(INT8_EXTRA)} edge cases of [int8] on their quantized '
          f'input): int32 accumulators bit-identical in all; fused output '
          f'worst |diff| fp32 {worst[f32]:.3e}, bf16 {worst[b16]:.3e}')
    return worst


def time_int8_s8(i8, card: str) -> dict:
    """The edge readers' shape at bs=32 from int8 input through the wrapper
    and alone (CUDA-graph replay), beside the same conv from fp32 / bf16
    input (the quantize pass included), its plain version, its bound and
    im2col + torch._int_mm. Returns, per output type, one forward's four
    launches: (ms, alone ms, plain ms, bound ms, bound_by, library ms)."""
    g = torch.Generator(device='cuda').manual_seed(10)
    B, ci, co, H, W, st = EDGE_READER
    x, wq, ws, qb, act = _int8_operands(g, B, ci, co, H, W, torch.float32)
    q = i8.quantize_plain(x, act)
    q16 = q.half()
    w2t = wq.permute(0, 3, 1, 2).reshape(co, -1).contiguous().t()
    lib = cuda_ms(lambda: _int_mm_conv(q16, w2t, st), iters=10)
    ops = 2 * B * H * W * co * 9 * ci
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        ms = cuda_ms(lambda: i8.int8_conv(q, wq, ws, qb, act, st,
                                          out_dtype=dt))
        alone = graph_ms(lambda: i8.int8_conv(q, wq, ws, qb, act, st,
                                              out_dtype=dt))
        plain = cuda_ms(lambda: i8.int8_conv_plain(q, wq, ws, qb, act, st,
                                                   out_dtype=dt),
                        iters=3, warmup=1)
        xf = x.to(dt)
        f_ms = cuda_ms(lambda: i8.int8_conv(xf, wq, ws, qb, act, st))
        f_alone = graph_ms(lambda: i8.int8_conv(xf, wq, ws, qb, act, st))
        esize = torch.finfo(dt).bits // 8
        nbytes = B * H * W * ci + co * 9 * ci + B * H * W * co * esize \
            + 8 * co + 4
        bms, bby = bound(ops, nbytes, INT8_TC)
        print(f'[time] int8 conv, edge reader B={B} {ci}->{co} {H}x{W} '
              f's{st}, {str(dt)[6:]} output: int8 input {ms:.4f} ms (alone '
              f'{alone:.4f}), {str(dt)[6:]} input {f_ms:.4f} (alone '
              f'{f_alone:.4f}); plain {plain:.4f}, im2col + _int_mm '
              f'{lib:.4f}, bound {bms:.4f} ({bby}; {ops / 1e9:.2f} GOP, '
              f'{nbytes / 1e6:.2f} MB), {bms / alone:.0%} of bound alone  '
              f'[{card}]')
        res[dt] = (4 * ms, 4 * alone, 4 * plain, 4 * bms, bby, 4 * lib)
    return res


def _bb_neck_ms(det, frames) -> dict:
    """Device ms of the backbone and the neck alone (CUDA events, 10 calls
    after 3 warm-up) on the letterboxed frames."""
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch
    m = det.model
    text, _ = det._text(None)
    with torch.inference_mode():
        canv, _ = letterbox_batch(frames, det.image_size)
        dt = m.box_head.box_convs[0][2].weight.dtype
        x = canv.permute(0, 3, 1, 2).to(dt).contiguous(
            memory_format=torch.channels_last)
        txt = text[None].expand(frames.shape[0], -1, -1).float()
        feats = m.backbone(x)
        return {'backbone': cuda_ms(lambda: m.backbone(x), iters=10),
                'neck': cuda_ms(lambda: m.neck(feats, txt), iters=10)}


def phase_int8_edges(sim, nms, i8, vocab_path, frames, shapes, card):
    """[int8 edges]: the int8-stored edges at variant 'n', 640 px, COCO-80.
    The int8-input conv against its plain version; then, at each of
    EDGE_SETTINGS (the port's threshold set for the phase and restored
    after), quantize_int8 on the INT8_CALIB frames of [int8] and fp32 and
    bf16 detect_batch at bs=32: the stored edges' out_scale count, 22 int8
    launches a forward of which the int8-input ones, kernels 1 and 2; card
    vs CPU at bs=2 with [int8]'s forcing (fp32 with 1 and 9 edges: 'off' is
    [int8]'s own gate; bf16 with 9 edges, the int8 blocks' outputs);
    img/s at each setting in turns, backbone and neck device ms, and the
    edge readers from int8 against float input. Returns (the path's
    launches, the kernel gate's worst differences, the readers' timing)."""
    from yoloclip_tpu_torch.models.yolo_clip import (YOLOCLIP,
                                                     cast_compute_dtype)
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch
    f32, b16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    worst = phase_int8_s8_kernel(i8, shapes)
    timing = time_int8_s8(i8, card)
    rng = np.random.RandomState(70)
    calib = torch.from_numpy(rng.randint(
        0, 256, (INT8_CALIB, 480, 640, 3), dtype=np.uint8)).cuda()
    dets, launches = {}, {}
    for tag, thr, n_edges, n_s8 in EDGE_SETTINGS:
        with _store_threshold(thr):
            for dt in ('float32', 'bfloat16'):
                d = _detector(vocab_path, dt)
                d.quantize_int8(calib)
                scales = sorted(k[:-len('.out_scale')]
                                for k in d.model.state_dict()
                                if k.endswith('.out_scale'))
                require(len(scales) == n_edges,
                        f'[int8 edges] {tag} {dt}: out_scale on {scales}, '
                        f'not {n_edges} blocks')
                _zero_int8(sim, nms, i8)
                out = d.detect_batch(frames)
                torch.cuda.synchronize()
                c = _int8_counts(sim, nms, i8)
                s8 = i8.launches_s8
                print(f'[int8 edges] {tag} (threshold {thr}), {dt} '
                      f'detect_batch bs={BATCH}: {len(scales)} stored '
                      f'edges {scales}; launches {c}, int8-input {s8}')
                require(i8.launches == INT8_BLOCKS and s8 == n_s8,
                        f'[int8 edges] {tag} {dt}: {i8.launches} int8 '
                        f'launches, {s8} with int8 input, not '
                        f'{INT8_BLOCKS} and {n_s8}')
                require(c['similarity'] + c['similarity_bf16'] == len(LEVELS)
                        and c['nms'] == 1,
                        f'[int8 edges] {tag} {dt}: kernels 1 and 2')
                require(_finite(out) and out['boxes'].shape[0] == BATCH,
                        f'[int8 edges] {tag} {dt} detect_batch output')
                key = '' if dt == 'float32' else '_bf16'
                c[f'int8_conv_s8{key}'] = s8
                for k, v in c.items():
                    launches[k] = launches.get(k, 0) + v
                dets[(tag, dt)] = d
            if thr == EDGE_SETTINGS[0][1]:
                continue
            # card vs CPU at bs=2 on the same quantized state, fp32
            d = dets[(tag, 'float32')]
            with torch.inference_mode():
                canv, _ = letterbox_batch(frames[:2], d.image_size)
            cpu = YOLOCLIP(d.model.cfg).eval()
            cpu.load_state_dict({k: v.cpu() for k, v in
                                 d.model.state_dict().items()})
            flips, total, worst_blk, got, free, want = _int8_card_vs_cpu(
                d.model, cpu, canv, d.offline_vocabulary)
            top2 = want['similarity'].topk(2, dim=-1).values
            tie = (top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP
            s_err = (got['scores'].cpu() - want['scores']).abs().max().item()
            bad = int(((got['class_ids'].cpu() != want['class_ids'])
                       & ~tie).sum())
            box_ok = torch.allclose(got['boxes'].cpu(), want['boxes'],
                                    rtol=XDEV_BOX_RTOL, atol=XDEV_BOX_ATOL)
            f_err = (got['scores'].cpu() - free['scores']).abs().max().item()
            print(f'[int8 edges] {tag}: bs=2 fp32 card vs CPU, same '
                  f'quantized state, int8 block inputs and stored edges '
                  f'forced to the card\'s: int8 block outputs within '
                  f'{worst_blk:.2e} relative (tol '
                  f'{INT8_TOL[f32][0]:g}); max|score diff|={s_err:.3e} (tol '
                  f'{XDEV_SCORE_ATOL:g}), id mismatches outside near-ties='
                  f'{bad}, boxes within rtol {XDEV_BOX_RTOL:g} atol '
                  f'{XDEV_BOX_ATOL:g}={box_ok}. Free-running (not gated): '
                  f'{flips} of {total} int8 values round apart, max|score '
                  f'diff| {f_err:.3e}')
            require(worst_blk <= INT8_TOL[f32][0]
                    and s_err <= XDEV_SCORE_ATOL and bad == 0 and box_ok,
                    f'[int8 edges] {tag}: card and CPU disagree')
            if n_s8:
                # bf16: each int8 block's output given the card's input
                d = dets[(tag, 'bfloat16')]
                cpu = cast_compute_dtype(YOLOCLIP(d.model.cfg).eval(), b16)
                cpu.load_state_dict({k: v.cpu() for k, v in
                                     d.model.state_dict().items()})
                _, _, worst_bf, *_ = _int8_card_vs_cpu(
                    d.model, cpu, canv, d.offline_vocabulary)
                print(f'[int8 edges] {tag}: bs=2 bf16 card vs CPU, int8 '
                      f'block inputs and stored edges forced: int8 block '
                      f'outputs within {worst_bf:.2e} relative (tol '
                      f'{INT8_TOL[b16][0]:g})')
                require(worst_bf <= INT8_TOL[b16][0],
                        f'[int8 edges] {tag} bf16: an int8 block\'s output '
                        f'differs on the card')
            del cpu, got, free, want

    # readings: img/s in turns (off, 1, 9, 9, 1, off), stage device ms
    rates = {}
    for dt in ('float32', 'bfloat16'):
        for tag, thr, _, _ in EDGE_SETTINGS + EDGE_SETTINGS[::-1]:
            with _store_threshold(thr):
                rates.setdefault((tag, dt), []).append(
                    _img_per_s(dets[(tag, dt)], frames))
    print(f'[time] int8 detect_batch bs={BATCH} 640px COCO-80, median of 10 '
          f'synced calls, edges off / 1 / 9 in turns (off, 1, 9, 9, 1, off),'
          f' img/s: ' + '; '.join(
              f'{dt} {tag} ' + ' / '.join(f'{v:.1f}' for v in vs)
              for (tag, dt), vs in rates.items()) + f'  [{card}]')
    for dt in ('float32', 'bfloat16'):
        parts = []
        for tag, thr, _, _ in EDGE_SETTINGS:
            with _store_threshold(thr):
                ms = _bb_neck_ms(dets[(tag, dt)], frames)
            parts.append(f'{tag} backbone {ms["backbone"]:.3f} neck '
                         f'{ms["neck"]:.3f}')
        print(f'[stages] int8 {dt}, bs={BATCH}, 640 px, device ms alone: '
              + '; '.join(parts) + f'  [{card}]')
    del dets
    print(f'[int8 edges] phase seconds: {time.perf_counter() - t0:.1f}  '
          f'[{card}]')
    return launches, worst, timing


def phase_stems(sim, nms, vocab_path, frames) -> dict:
    """stem_s2d and stem_u8_s2d detectors (fp32, the same seeded weights)
    against the plain stem on the same frames: pre-NMS outputs within
    STEM_TOL, ids exact outside near-ties; detect_batch runs. Returns the
    launches of the two detect_batch calls."""
    from yoloclip_tpu_torch.ops.preprocess import (letterbox_batch,
                                                   letterbox_batch_u8_s2d)
    base = _detector(vocab_path)
    text = base.offline_vocabulary
    with torch.inference_mode():
        canv, _ = letterbox_batch(frames, base.image_size)
        want = base.model(canv, text)
    top2 = want['similarity'].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < STEM_TIE_GAP
    del base
    total = {}
    for flag in ('stem_s2d', 'stem_u8_s2d'):
        d = _detector(vocab_path, model_kw={flag: True})
        with torch.inference_mode():
            x = (letterbox_batch_u8_s2d(frames, d.image_size)[0]
                 if flag == 'stem_u8_s2d' else canv)
            got = d.model(x, text)
        tol = STEM_TOL[flag]
        box_ok = torch.allclose(got['boxes'], want['boxes'],
                                rtol=tol['box'][0], atol=tol['box'][1])
        score_ok = torch.allclose(got['scores'], want['scores'],
                                  rtol=tol['score'][0], atol=tol['score'][1])
        bad = int(((got['class_ids'] != want['class_ids']) & ~tie).sum())
        s_err = (got['scores'] - want['scores']).abs().max().item()
        _zero_counts(sim, nms)
        out = d.detect_batch(frames)
        torch.cuda.synchronize()
        launches = _counts(sim, nms)
        print(f'[stems] {flag} vs the plain stem, fp32, bs={BATCH}: '
              f'max|score diff|={s_err:.3e}, scores within rtol '
              f'{tol["score"][0]:g} atol {tol["score"][1]:g}={score_ok}, '
              f'boxes within rtol {tol["box"][0]:g} atol {tol["box"][1]:g}'
              f'={box_ok}, id mismatches outside near-ties={bad}; '
              f'detect_batch launches {launches}')
        require(box_ok and score_ok and bad == 0 and _finite(out)
                and launches['similarity'] > 0 and launches['nms'] > 0,
                f'{flag} disagrees with the plain stem')
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        del d, got, out
    return total


# ---------------------------------------------------------------------------
# Training and evaluation (YOLOCLIPTrainer at variant 'n', 640 px).
# ---------------------------------------------------------------------------

# One train step, card (cuDNN, TF32 off) against the same step on the
# CPU in float64 (the losses themselves compute in fp32) from one seeded
# state. The CPU's own fp32 train step is no reference at 640 px: its
# train-mode BatchNorm statistics over 819,200 values a channel put its
# stem 2.8e-5 from float64 and its last layers 8.5e-4, where the card's
# sit 2.4e-7 and 2.3e-5 away (an NVIDIA H100 80GB HBM3 at 700 W).
# Gradients get a relative L2 tolerance (cuDNN's backward convs reduce in
# another order); Adam's first step moves each element by
# lr * g / (|g| + eps), i.e. +-lr, so an element whose gradient is within
# rounding of 0 flips by 2 lr: the card's parameters are held against the
# CPU's AdamW on the card's own gradients.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
TRAIN_BUF_ATOL, TRAIN_PARAM_ATOL = 1e-5, 1e-6
TRAIN_BS, TRAIN_WARMUP, TRAIN_STEPS, EVAL_IMAGES = 16, 3, 10, 32
OVERFIT_STEPS = 120


# ---------------------------------------------------------------------------
# export: torch.export artifacts of the detector through the custom ops,
# loaded in a fresh interpreter that imports only utils/export.py.

EXPORT_SMALL = (2, 160, 160)   # the artifact traced on the card, run on CPU
EXPORT_CHILD = r"""
import json, statistics, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from yoloclip_tpu_torch.utils import export as E
tmp = sys.argv[1]
with open(tmp + '/manifest.json') as f:
    man = json.load(f)
x = torch.load(tmp + '/canvases.pt').cuda()

def counts():
    return {'similarity': E._sim.launches - E._sim.launches_bf16,
            'similarity_bf16': E._sim.launches_bf16, 'nms': E._nms.launches,
            'int8_conv': E._int8.launches - E._int8.launches_bf16,
            'int8_conv_bf16': E._int8.launches_bf16}

def zero():
    E._sim.launches = E._sim.launches_bf16 = E._nms.launches = 0
    E._int8.launches = E._int8.launches_bf16 = 0

res = {}
with torch.no_grad():
    for name, path in man['cuda'].items():
        t0 = time.perf_counter()
        fn = E.load_exported(path)
        load_s = time.perf_counter() - t0
        fn(x)
        torch.cuda.synchronize()
        zero()
        out = fn(x)
        torch.cuda.synchronize()
        launched = counts()
        times = []
        for _ in range(10):
            t = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        torch.save({k: v.cpu() for k, v in out.items()},
                   f'{tmp}/{name}.out.pt')
        res[name] = {'launches': launched, 'load_s': load_s,
                     'ms': statistics.median(times) * 1e3}
    fn = E.load_exported(man['cpu'], device='cpu')
    zero()
    out = fn(torch.load(tmp + '/small.pt'))
    res['cpu'] = {'launches': counts()}
    torch.save(out, tmp + '/cpu.out.pt')
mods = sorted(m for m in sys.modules
              if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yoloclip_tpu')
              or m.startswith(('yoloclip_tpu_torch.models',
                               'yoloclip_tpu_torch.inference')))
print(json.dumps({'res': res, 'mods': mods}))
"""


def _export_diff(tag, got, want):
    """An artifact's NMS dict against the eager one: count, class ids and
    validity equal, boxes within the cross-device bounds, scores within
    SIM_ATOL. Returns (max |box diff|, max |score diff|, bit-equal)."""
    for k in ('count', 'class_ids', 'valid'):
        require(torch.equal(got[k].cpu(), want[k].cpu().to(got[k].dtype)),
                f'[export] {tag}: {k} differs from the eager path')
    gb, wb = got['boxes'].cpu(), want['boxes'].cpu()
    require(torch.allclose(gb, wb, rtol=XDEV_BOX_RTOL, atol=XDEV_BOX_ATOL),
            f'[export] {tag}: boxes differ from the eager path')
    s_err = (got['scores'].cpu() - want['scores'].cpu()).abs().max().item()
    require(s_err <= SIM_ATOL, f'[export] {tag}: scores differ by {s_err}')
    same = all(torch.equal(got[k].cpu(), want[k].cpu().to(got[k].dtype))
               for k in want)
    return (gb - wb).abs().max().item(), s_err, same


def _dispatch_ab(detectors, frames, rounds: int = 5) -> dict:
    """img/s of each detector's eager detect_batch body (a replayed
    program dispatches nothing) with each kernel's implementation called
    straight, as the port's eager calls do, and through the custom ops
    (`KernelOp.__call__` swapped for the measurement), in turns; medians
    over the rounds. Also the host time of one small kernel-2 call both
    ways."""
    from yoloclip_tpu_torch.ops.kernels import library
    straight = library.KernelOp.__call__

    def through(self, lead, *args):
        return self.op(lead, *args)

    from yoloclip_tpu_torch.ops.kernels import nms
    boxes = torch.rand((1, 32, 4), device='cuda')
    boxes[..., 2:] += 1.0
    valid = torch.ones((1, 32), dtype=torch.bool, device='cuda')

    def host_us(calls: int = 2000) -> float:
        """Host microseconds a call of a 32-box NMS keep (launches queue
        up; the host's share is what the dispatcher adds to)."""
        for _ in range(50):
            nms.nms_keep(boxes, valid, 0.45)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            nms.nms_keep(boxes, valid, 0.45)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    rates = {(n, d): [] for n in list(detectors) + ['us a call']
             for d in (True, False)}
    try:
        for _ in range(rounds):
            for direct in (True, False):
                library.KernelOp.__call__ = straight if direct else through
                with torch.inference_mode():
                    rates[('us a call', direct)].append(host_us())
                for name, det in detectors.items():
                    rates[(name, direct)].append(
                        _img_per_s(det, frames, eager=True))
    finally:
        library.KernelOp.__call__ = straight
    return {k: statistics.median(v) for k, v in rates.items()}


def phase_export(sim, nms, i8, det, bf, vocab_path, frames, tmp, card):
    """`utils/export.py` on the card: the fp32, bf16 and int8 fp32 COCO-80
    detectors (variant 'n', bs=32, 640 px, NMS in, conf -1.0) exported,
    saved and run in a fresh interpreter that imports only
    `utils/export.py`, against the eager model + batched_nms on the same
    letterboxed frames; one artifact call's launches (3 kernel-1, 1
    kernel-2, int8 22 int8 convs); a bs=2 160-px artifact traced on the
    card run on the CPU against the CPU eager path; export seconds, bytes,
    img/s beside eager; the custom-op dispatch A/B. Returns the launches
    of the artifact calls."""
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.ops.nms import batched_nms
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch
    from yoloclip_tpu_torch.utils.export import export_detector
    nms_kw = dict(conf_threshold=-1.0, iou_threshold=det.iou_threshold,
                  nms_topk=det.config.nms_topk,
                  max_detections=det.config.max_detections)
    ref_kw = dict(conf_threshold=-1.0, iou_threshold=det.iou_threshold,
                  topk=det.config.nms_topk,
                  max_detections=det.config.max_detections)
    rng = np.random.RandomState(80)
    calib = torch.from_numpy(rng.randint(
        0, 256, (INT8_CALIB, 480, 640, 3), dtype=np.uint8)).cuda()
    q32 = _detector(vocab_path)
    q32.quantize_int8(calib)
    qbf = _detector(vocab_path, 'bfloat16')
    qbf.quantize_int8(calib)
    dets = {'fp32': det, 'bf16': bf, 'int8': q32}
    with torch.inference_mode():
        canv, _ = letterbox_batch(frames, det.image_size)
    canv = canv.clone()
    torch.save(canv.cpu(), os.path.join(tmp, 'canvases.pt'))
    B, H, W = canv.shape[:3]
    man, info = {'cuda': {}}, {}
    for name, d in dets.items():
        path = os.path.join(tmp, f'{name}.pt2')
        t0 = time.perf_counter()
        export_detector(d.model, d.offline_vocabulary, (B, H, W), path,
                        **nms_kw)
        info[name] = (time.perf_counter() - t0, os.path.getsize(path))
        man['cuda'][name] = path
    # traced on the card, run on the CPU
    small = os.path.join(tmp, 'small.pt2')
    export_detector(det.model, det.offline_vocabulary, EXPORT_SMALL, small,
                    include_nms=False)
    man['cpu'] = small
    xs = torch.from_numpy(np.random.RandomState(81).rand(
        *EXPORT_SMALL, 3).astype(np.float32))
    torch.save(xs, os.path.join(tmp, 'small.pt'))
    with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
        json.dump(man, f)
    print('[export] exported (bs=32, 640 px, NMS in; export + save): ' +
          ', '.join(f'{n} {s:.1f} s {b / 2 ** 20:.1f} MiB'
                    for n, (s, b) in info.items()) + f'  [{card}]')

    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', EXPORT_CHILD, tmp],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    child_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f'[export] the loading process failed:\n{proc.stderr[-3000:]}')
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    require(child['mods'] == [], f'[export] the loading process imported '
            f'{child["mods"]}')
    res = child['res']

    expect = {'fp32': {'similarity': 3, 'nms': 1},
              'bf16': {'similarity_bf16': 3, 'nms': 1},
              'int8': {'similarity': 3, 'nms': 1, 'int8_conv': INT8_BLOCKS}}
    launches = {}
    for name, d in dets.items():
        got_n = res[name]['launches']
        want_n = {k: expect[name].get(k, 0) for k in got_n}
        require(got_n == want_n, f'[export] {name} artifact launched '
                f'{got_n}, not {want_n}')
        for k, v in got_n.items():
            launches[k] = launches.get(k, 0) + v
        got = torch.load(os.path.join(tmp, f'{name}.out.pt'))
        with torch.inference_mode():
            out = d.model(canv, d.offline_vocabulary, fused_scores=True)
            want = batched_nms(out['boxes'], out['scores'], out['class_ids'],
                               **ref_kw)
        b_err, s_err, same = _export_diff(name, got, want)
        def eager(d=d):
            with torch.inference_mode():    # as detect_batch runs
                o = d.model(canv, d.offline_vocabulary, fused_scores=True)
                return batched_nms(o['boxes'], o['scores'], o['class_ids'],
                                   **ref_kw)

        eager_ms = _synced_ms(eager)
        rate = _img_per_s(d, frames)
        print(f'[export] {name} artifact in a fresh process (load '
              f'{res[name]["load_s"]:.2f} s): one call launched {got_n}; '
              f'vs eager model + batched_nms: count, class_ids, valid equal, '
              f'max|box diff| {b_err:.3e}, max|score diff| {s_err:.3e}, '
              f'bit-equal {same}; {B / res[name]["ms"] * 1e3:.1f} img/s '
              f'({res[name]["ms"]:.3f} ms a call on canvases) vs eager '
              f'{B / eager_ms * 1e3:.1f} img/s on the same canvases, '
              f'detect_batch (program) {rate:.1f} img/s  [{card}]')
    require(res['cpu']['launches'] == {k: 0 for k in res['cpu']['launches']},
            '[export] the artifact moved to the CPU launched a kernel')

    cpu = YOLOCLIPDetector(InferenceConfig(host_preprocess=False),
                           vocab_path=vocab_path, device='cpu', seed=0)
    got = torch.load(os.path.join(tmp, 'cpu.out.pt'))
    with torch.inference_mode():
        want = cpu.model(xs, cpu.offline_vocabulary)
    top2 = want['similarity'].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP
    s_err = (got['scores'] - want['scores']).abs().max().item()
    bad = int(((got['class_ids'] != want['class_ids']) & ~tie).sum())
    box_ok = torch.allclose(got['boxes'], want['boxes'], rtol=XDEV_BOX_RTOL,
                            atol=XDEV_BOX_ATOL)
    print(f'[export] bs=2 160-px artifact traced on the card, run on the CPU '
          f'(move_to_device_pass) vs the CPU eager path: max|score diff| '
          f'{s_err:.3e} (tol {XDEV_SCORE_ATOL:g}), id mismatches outside '
          f'near-ties {bad}, boxes within rtol {XDEV_BOX_RTOL:g} atol '
          f'{XDEV_BOX_ATOL:g} {box_ok}; loading process {child_s:.1f} s')
    require(s_err <= XDEV_SCORE_ATOL and bad == 0 and box_ok,
            '[export] the CPU-moved artifact disagrees with the CPU path')

    ab = _dispatch_ab({'float bf16': bf, 'int8 bf16': qbf}, frames)
    us_direct, us_op = ab[('us a call', True)], ab[('us a call', False)]
    print(f'[export] dispatch A/B, host time of one kernel-2 call (32 boxes, '
          f'median of 5 rounds of 2000 calls): straight {us_direct:.2f} us, '
          f'through the custom op {us_op:.2f} us (+{us_op - us_direct:.2f} '
          f'us a call)  [{card}]')
    for name, calls in (('float bf16', 4), ('int8 bf16', 4 + INT8_BLOCKS)):
        direct, op = ab[(name, True)], ab[(name, False)]
        print(f'[export] dispatch A/B, {name} detect_batch bs={BATCH} (median '
              f'of 5 rounds in turns, each a median of 10 synced calls; '
              f'{calls} kernel calls a forward): straight {direct:.1f} img/s, '
              f'through the custom ops {op:.1f} img/s, op cost '
              f'{(direct - op) / direct * 100:.2f} % (the per-call cost '
              f'predicts {(us_op - us_direct) * calls / (BATCH / direct * 1e6) * 100:.2f} %)  [{card}]')
    return launches


def _train_batch(n: int, seed: int, size: int = 640, classes: int = 80):
    """A synthetic detection batch at full width, numpy: 2-8 objects of
    32-256 px per image, `classes` class ids, 100 target slots, and every
    image's prompts the 80 COCO names (a (n, 128, 512) text bucket)."""
    from yoloclip_tpu_torch.config import COCO_CLASS_NAMES
    from yoloclip_tpu_torch.data.synth import make_synth_detection_set
    batch = make_synth_detection_set(n, seed, image_size=size,
                                     max_objects=100, num_classes=classes,
                                     min_side=32, max_side=256,
                                     objects=(2, 8))
    names = COCO_CLASS_NAMES[:classes]
    batch['text_prompts'] = [[f'a photo of a {c}' for c in names]] * n
    return batch


def _train_cfg(size: int = 640, **kw):
    from yoloclip_tpu_torch.config import ModelConfig, TrainingConfig
    dtype = kw.pop('dtype', 'float32')
    return TrainingConfig(model=ModelConfig(image_size=(size, size),
                                            dtype=dtype), **kw)


def _seeded_model(cfg, seed: int = 0):
    from yoloclip_tpu_torch.models.yolo_clip import YOLOCLIP, init_weights
    model = YOLOCLIP(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def phase_train_step_xdev() -> None:
    """One compat fp32 AdamW step at variant 'n', 640 px, bs=2 on the card
    against the same step in float64 on the CPU, from one seeded state on
    the same batch and text."""
    import copy

    from yoloclip_tpu_torch.train import train_state as ts
    cfg = _train_cfg()
    batch = _train_batch(2, 1)
    g = torch.Generator().manual_seed(1)
    text = torch.randn((2, 128, EMBED), generator=g)
    text[:, 80:] = 0.0
    before = copy.deepcopy(_seeded_model(cfg).state_dict())
    states, parts = {}, {}
    for key, dev, dt in (('card', 'cuda', torch.float32),
                         ('ref', 'cpu', torch.float64)):
        m = _seeded_model(cfg).to(dev, dt)
        st = ts.TrainState(m, ts.make_optimizer(cfg, m.parameters()))
        ts.set_learning_rate(st, cfg.learning_rate)
        b = {k: torch.from_numpy(batch[k]).to(dev) for k in
             ('images', 'boxes', 'class_ids', 'valid_mask')}
        b['images'] = b['images'].to(dt)
        t = time.perf_counter()
        parts[key] = ts.make_train_step(cfg)(st, b, text.to(dev, dt))
        torch.cuda.synchronize()
        states[key] = (st, time.perf_counter() - t)
    loss_err = max(abs(parts['card'][k].item() - parts['ref'][k].item())
                   / max(abs(parts['ref'][k].item()), 1e-12)
                   for k in parts['ref'] if parts['ref'][k].item() != 0)
    cu, cp = states['card'][0].model, states['ref'][0].model
    grads_cpu = {k: p.grad for k, p in cp.named_parameters()}
    top = max(float(g.norm()) for g in grads_cpu.values())
    grad_err, worst = 0.0, ''
    for k, p in cu.named_parameters():
        w = grads_cpu[k]
        if float(w.norm()) > 1e-6 * top:
            e = float((p.grad.cpu().double() - w).norm() / w.norm())
            if e > grad_err:
                grad_err, worst = e, k
    sd_cu, sd_cp = cu.state_dict(), cp.state_dict()
    buf_err = max((sd_cu[k].cpu().double() - sd_cp[k]).abs().max().item()
                  for k in sd_cp if k.endswith(('running_mean',
                                                'running_var')))
    # the CPU's AdamW applied to the card's gradients
    ref = _seeded_model(cfg)
    ref.load_state_dict(before)
    opt = ts.make_optimizer(cfg, ref.parameters())
    for (k, p), q in zip(ref.named_parameters(), cu.parameters()):
        p.grad = q.grad.detach().cpu()
    opt.step()
    sd_ref = ref.state_dict()
    names = [k for k, _ in cu.named_parameters()]
    param_err = max((sd_cu[k].cpu() - sd_ref[k]).abs().max().item()
                    for k in names)
    direct = max((sd_cu[k].cpu().double() - sd_cp[k]).abs().max().item()
                 for k in names)
    flips = sum(int(((p.grad.cpu() > 0) != (grads_cpu[k] > 0)).sum())
                for k, p in cu.named_parameters())
    print(f'[train xdev] compat fp32 bs=2 640 px one AdamW step, card '
          f'({states["card"][1]:.1f} s with warm-up) vs the CPU in float64 '
          f'({states["ref"][1]:.1f} s): loss parts max rel {loss_err:.3e} '
          f'(tol {TRAIN_LOSS_RTOL:g}); gradients max rel L2 {grad_err:.3e} '
          f'(tol {TRAIN_GRAD_RTOL:g}, {worst}); BatchNorm buffers max abs '
          f'{buf_err:.3e} (tol {TRAIN_BUF_ATOL:g}); parameters vs the CPU '
          f'AdamW on the card gradients max abs {param_err:.3e} (tol '
          f'{TRAIN_PARAM_ATOL:g}); parameters card vs CPU step max abs '
          f'{direct:.3e} with {flips} gradient elements of opposite sign')
    require(loss_err <= TRAIN_LOSS_RTOL, 'card and CPU losses disagree')
    require(grad_err <= TRAIN_GRAD_RTOL, 'card and CPU gradients disagree')
    require(buf_err <= TRAIN_BUF_ATOL, 'card and CPU BatchNorm buffers')
    require(param_err <= TRAIN_PARAM_ATOL, 'card AdamW vs the CPU AdamW')


def _step_breakdown(trainer, batch, card: str, tag: str) -> None:
    """torch.profiler over one train step (`utils/profiling.py`): the top
    10 CUDA kernels by device time and the device's idle share of the
    step's host span."""
    from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                    trace)
    trainer.train_epoch([batch], 1)
    torch.cuda.synchronize()
    with trace(os.path.join(trainer.output_dir, 'trace')) as prof:
        with annotate('train_step'):
            trainer.train_epoch([batch], 1)
            torch.cuda.synchronize()
    summary = device_summary(prof, span='train_step')
    if summary['idle_share'] is None:
        print('[train breakdown] not measured (the profiler recorded no '
              'device event)')
        return
    by_name = summary['kernels']
    total = sum(v[0] for v in by_name.values())
    print(f'[train breakdown] {tag} bs={TRAIN_BS} 640 px, one step: '
          f'host span {summary["span_ms"]:.2f} ms, device busy '
          f'{summary["busy_ms"]:.2f} ms, idle share '
          f'{summary["idle_share"]:.3f}, '
          f'{sum(v[1] for v in by_name.values())} device activities, '
          f'{total:.2f} ms summed ({card})')
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        print(f'[train breakdown]   {ms:8.3f} ms  {n:5d}x  '
              f'{100 * ms / total:5.1f} %  {name[:110]}')


def phase_training(nms, text_encoder, tmp: str, card: str) -> None:
    """YOLOCLIPTrainer at bs=16, 640 px, COCO-80 prompts: step ms, img/s
    and peak memory for compat fp32, clean fp32 and clean bf16; evaluate
    with NMS on 32 images (kernel 2); the step breakdown of clean fp32 and
    bf16."""
    from yoloclip_tpu_torch.data.loader import device_prefetch
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    batch = next(device_prefetch(iter([_train_batch(TRAIN_BS, 2)]), 'cuda'))
    val = list(device_prefetch(iter([_train_batch(TRAIN_BS, 3 + i)
                                     for i in range(EVAL_IMAGES
                                                    // TRAIN_BS)]),
                               'cuda'))
    for assigner, dtype in (('compat', 'float32'),
                            ('topk_center', 'float32'),
                            ('topk_center', 'bfloat16')):
        cfg = _train_cfg(assigner=assigner, dtype=dtype, eval_with_nms=True,
                         batch_size=TRAIN_BS,
                         output_dir=os.path.join(tmp, 'train'))
        trainer = YOLOCLIPTrainer(_seeded_model(cfg), text_encoder, cfg,
                                  device='cuda')
        trainer.train_epoch([batch] * TRAIN_WARMUP, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        losses = trainer.train_epoch([batch] * TRAIN_STEPS, 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / TRAIN_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        require(all(np.isfinite(v) for v in losses.values()),
                f'non-finite {assigner} {dtype} training loss')
        # the same epoch through the eager body, for the reading beside
        program_step = trainer._train_step
        trainer._train_step = trainer._train_step_eager
        try:
            trainer.train_epoch([batch] * TRAIN_WARMUP, 1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            trainer.train_epoch([batch] * TRAIN_STEPS, 1)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t) / TRAIN_STEPS * 1e3
        finally:
            trainer._train_step = program_step
        print(f'[train] {assigner} {dtype} bs={TRAIN_BS} 640 px '
              f'(train_epoch, the train program): {ms:.2f} ms/step, '
              f'{TRAIN_BS / ms * 1e3:.1f} img/s, peak {peak:.2f} GiB, loss '
              f'{losses["loss"]:.4f}; the eager body {eager_ms:.2f} ms/step, '
              f'{TRAIN_BS / eager_ms * 1e3:.1f} img/s ({card})')
        if (assigner, dtype) == ('topk_center', 'float32'):
            before = nms.launches
            t = time.perf_counter()
            metrics = trainer.evaluate(val)
            ms = (time.perf_counter() - t) * 1e3
            n = nms.launches - before
            print(f'[train] evaluate eval_with_nms=True on {EVAL_IMAGES} '
                  f'images: {ms:.1f} ms, mAP50 {metrics["mAP50"]:.4f}, '
                  f'mAP50-95 {metrics["mAP50_95"]:.4f}, loss '
                  f'{metrics["loss"]:.4f}, NMS kernel launches {n}')
            require(n == EVAL_IMAGES // TRAIN_BS,
                    'evaluate did not launch kernel 2 once a batch')
            require(np.isfinite(metrics['loss']), 'evaluate loss')
        if assigner == 'topk_center':
            _step_breakdown(trainer, batch, card,
                            f'clean {dtype} (the train program)')
        del trainer


@contextlib.contextmanager
def _deterministic(on: bool = True):
    """torch.use_deterministic_algorithms and cuDNN's deterministic
    algorithms set to `on` inside the block."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic = was[1]


def train_overfit(tmp: str, steps: int = OVERFIT_STEPS,
                  deterministic: bool = True) -> dict:
    """The overfit twin's training: steps + 1 clean steps at 128 px, bs=4,
    on 4 images of one white square, the lr on the trainer's OneCycle
    curve (step units, peak 2e-3 at the first step), under
    torch.use_deterministic_algorithms and cuDNN's deterministic
    algorithms unless `deterministic` is false; the checkpoint and a
    2-class vocabulary ('square', 'other') written under tmp.
    `tools/overfit_repeat.py` repeats it."""
    from yoloclip_tpu_torch.train import train_state as ts
    from yoloclip_tpu_torch.utils.checkpoint import save_checkpoint
    cfg = _train_cfg(128, max_objects=4, batch_size=4,
                     assigner='topk_center')
    B = 4
    img = np.zeros((B, 128, 128, 3), np.float32)
    boxes = np.zeros((B, 4, 4), np.float32)
    valid = np.zeros((B, 4), bool)
    rs = np.random.RandomState(0)
    for b in range(B):
        x0, y0 = rs.randint(10, 60), rs.randint(10, 60)
        w, h = rs.randint(30, 50), rs.randint(30, 50)
        img[b, y0:y0 + h, x0:x0 + w] = 1.0
        boxes[b, 0] = [x0, y0, x0 + w, y0 + h]
        valid[b, 0] = True
    batch = {'images': torch.from_numpy(img).cuda(),
             'boxes': torch.from_numpy(boxes).cuda(),
             'class_ids': torch.zeros((B, 4), dtype=torch.int32,
                                      device='cuda'),
             'valid_mask': torch.from_numpy(valid).cuda()}
    text = torch.randn((2, EMBED), generator=torch.Generator().manual_seed(0))
    text = text / text.norm(dim=-1, keepdim=True)
    state = ts.create_train_state(_seeded_model(cfg), cfg, 'cuda')
    step = ts.make_train_step(cfg)
    sched = ts.make_onecycle_schedule(2e-3, steps + 1, 1)
    textb = text[None].expand(B, -1, -1).cuda()
    t = time.perf_counter()
    with _deterministic(deterministic):
        ts.set_learning_rate(state, sched(0))
        first = step(state, batch, textb)['loss'].item()
        for i in range(1, steps + 1):
            ts.set_learning_rate(state, sched(i))
            parts = step(state, batch, textb)
        last = parts['loss'].item()
    secs = time.perf_counter() - t
    digest = sum(float(p.detach().double().sum())
                 for p in state.model.parameters())
    path = os.path.join(tmp, 'overfit.pt')
    save_checkpoint(path, state.model.state_dict(), step=state.step)
    vocab = os.path.join(tmp, 'overfit_vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'square': text[0].tolist(), 'other': text[1].tolist()}, f)
    return {'cfg': cfg, 'img': img, 'boxes': boxes, 'path': path,
            'vocab': vocab, 'first': first, 'last': last, 'secs': secs,
            'digest': digest}


def overfit_detector(run: dict, conf: float):
    """The overfit checkpoint served by YOLOCLIPDetector (kernels 1 and 2)
    at `conf`, IoU 0.45, 8 boxes an image at most."""
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    return YOLOCLIPDetector(
        InferenceConfig(model=run['cfg'].model, conf_threshold=conf,
                        iou_threshold=0.45, nms_topk=256, max_detections=8,
                        host_preprocess=False),
        vocab_path=run['vocab'], model_path=run['path'], device='cuda',
        seed=0)


def phase_overfit(tmp: str) -> None:
    """The twin of tests/test_convergence.py on the card (`train_overfit`:
    121 clean steps): the loss must fall below 0.25 of the first step's;
    the checkpoint, served at conf 0.25, must find exactly the square in
    each image, class 0, IoU >= 0.5. (The JAX test holds the lr at 2e-3:
    its detections then hang on the last steps' oscillation, and a 1e-6
    change of its initial weights turns one image's one box into two;
    annealed, six of six initial states passed on the CPU.) The steps run
    deterministically: with the card's default reductions (the I-Pool's
    adaptive max pool backward adds overlapping windows atomically) the
    outcome differed from run to run, and now and then image 2 got two
    boxes, at 121 steps and at 241 (`tools/overfit_repeat.py`)."""
    from yoloclip_tpu_torch.ops.boxes import pairwise_iou
    run = train_overfit(tmp)
    img, boxes = run['img'], run['boxes']
    out = overfit_detector(run, 0.25).detect_batch(torch.from_numpy(
        (img * 255).astype(np.uint8)).cuda())
    ious = []
    for b in range(len(img)):
        require(int(out['count'][b]) == 1,
                f'overfit image {b}: {int(out["count"][b])} detections')
        require(int(out['class_ids'][b][0]) == 0, f'overfit image {b} class')
        ious.append(float(pairwise_iou(
            out['boxes'][b][:1].cpu(), torch.from_numpy(boxes[b, :1]))[0, 0]))
    first, last = run['first'], run['last']
    print(f'[overfit] {OVERFIT_STEPS + 1} clean deterministic steps at '
          f'128 px bs=4 in {run["secs"]:.1f} s: loss {first:.4f} -> '
          f'{last:.6f} (must fall below {0.25 * first:.4f}), parameter sum '
          f'{run["digest"]:.9e}; detect_batch: one box per image, class 0, '
          f'IoU {", ".join(f"{i:.3f}" for i in ious)}')
    require(last < 0.25 * first, 'overfit loss did not fall below 0.25x')
    require(min(ious) >= 0.5, 'overfit detection IoU below 0.5')
    return img, boxes, run['path'], run['vocab']


def phase_eval_cli(img, boxes, ckpt: str, vocab: str, tmp: str) -> None:
    """`python -m yoloclip_tpu_torch.cli.eval` (in process) on the overfit
    images written as PNG files with their squares as COCO ground truth,
    the overfit checkpoint served through detect() (kernels 1 and 2) --
    where this machine can decode a PNG file; otherwise it says so."""
    import contextlib
    import io

    from yoloclip_tpu_torch.data.coco import _imread_rgb
    root = os.path.join(tmp, 'eval_cli')
    os.makedirs(root, exist_ok=True)
    frames = (img * 255).astype(np.uint8)
    images, anns = [], []
    for i, frame in enumerate(frames):
        with open(os.path.join(root, f'{i}.png'), 'wb') as f:
            f.write(_png(frame))
        images.append({'id': i, 'file_name': f'{i}.png', 'width': 128,
                       'height': 128})
        x0, y0, x1, y1 = (float(v) for v in boxes[i, 0])
        anns.append({'id': i + 1, 'image_id': i, 'category_id': 1,
                     'bbox': [x0, y0, x1 - x0, y1 - y0],
                     'area': (x1 - x0) * (y1 - y0), 'iscrowd': 0})
    anno = os.path.join(root, 'anno.json')
    with open(anno, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': 1, 'name': 'square'},
                                  {'id': 2, 'name': 'other'}]}, f)
    cfg = os.path.join(root, 'cfg.yaml')
    with open(cfg, 'w') as f:
        f.write('image_size: [128, 128]\nnms_topk: 256\nmax_detections: 8\n')
    try:
        import yaml  # noqa: F401
        decoded = _imread_rgb(os.path.join(root, '0.png'))
    except (ImportError, FileNotFoundError) as e:
        print(f'[eval cli] no PNG file decoder or YAML reader on this '
              f'machine ({type(e).__name__}: {e}): cli.eval was not run')
        return
    require(np.array_equal(decoded, frames[0]), 'PNG file decode')
    from yoloclip_tpu_torch.cli.eval import main as eval_main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = eval_main(['--anno', anno, '--images', root, '--config', cfg,
                        '--model', ckpt, '--vocab', vocab, '--conf',
                        '0.25', '--device', 'cuda'])
    lines = out.getvalue().strip().splitlines()
    print(f'[eval cli] overfit checkpoint on its 4 images: '
          f'{" | ".join(lines)}')
    require(rc == 0 and any(ln.startswith('mAP@50:') for ln in lines),
            'cli.eval failed')
    map50 = float(lines[-1].split()[1])
    require(map50 >= 0.5, f'cli.eval mAP@50 {map50} on the overfit images')


def phases_training(sim, nms, tmp: str, card: str) -> dict:
    """The training phases; returns the launches of the training path (the
    timed steps, evaluate and the overfit detector), counted from 0."""
    from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder
    phase_train_step_xdev()
    encoder = CLIPTextEncoder(device='cuda', seed=0)
    _zero_counts(sim, nms)
    phase_training(nms, encoder, tmp, card)
    phase_eval_cli(*phase_overfit(tmp), tmp)
    torch.cuda.synchronize()
    launches = _counts(sim, nms)
    del encoder
    gc.collect()                          # the trainers' graphs
    torch.cuda.empty_cache()
    print(f'[train] launches on the training path (evaluate, overfit '
          f'detect_batch, cli.eval where it ran): {launches}')
    require(launches['nms'] > 0 and launches['similarity'] > 0,
            'the training path did not launch kernels 1 and 2')
    return launches


# ---------------------------------------------------------------------------
# [train graphs]: the trainer's train and eval steps and the text tower's
# encode as programs (inference/program.py) against their eager bodies,
# under deterministic algorithms, so that each pair must agree bit for bit.
# ---------------------------------------------------------------------------

# (tag, assigner, dtype, grad_accum_steps, ema_decay) at bs=16, 640 px
TRAIN_GRAPH_CASES = (('compat fp32', 'compat', 'float32', 1, 0.0),
                     ('clean fp32 accum 2 EMA', 'topk_center', 'float32', 2,
                      0.9999),
                     ('clean bf16', 'topk_center', 'bfloat16', 1, 0.0))
TRAIN_GRAPH_STEPS = 3     # steps through the program and the eager body
TRAIN_GRAPH_TIMED = 3     # steps a turn in the A/B
TRAIN_GRAPH_TRACED = 1    # steps a span in the trace (as [train breakdown])
ONLINE_PROMPTS = 8        # the online prompt batch
# the case that also resumes from a CPU trainer's checkpoint
RESUME_CASE = 'clean fp32 accum 2 EMA'
RESUME_STEPS = 2          # the new program's capture, then a replay
# the pool-growth sequence (clean bf16, one trainer): per-sample classes of
# the train batches (class buckets 8, 32, 128), then a partial last batch
# of POOL_LAST rows and an eval batch at 8 classes
POOL_CLASSES = (8, 32, 80)
POOL_LAST = 8


def _train_state_diff(got, want) -> list:
    """The tensors of two TrainStates that are not bit-equal: parameters
    and BatchNorm buffers, EMA, the optimizer's state."""
    g = got.model.state_dict()
    bad = [k for k, v in want.model.state_dict().items()
           if not torch.equal(g[k], v)]
    if want.ema is not None:
        bad += [f'ema {k}' for k, v in want.ema.items()
                if not torch.equal(got.ema[k], v)]
    for (name, p), q in zip(got.model.named_parameters(),
                            want.model.parameters()):
        sp, sq = got.optimizer.state[p], want.optimizer.state[q]
        bad += [f'optimizer {name} {k}' for k in sq
                if not torch.equal(sp[k], sq[k])]
    return bad


def _steps_ms(step, n: int) -> float:
    """Host ms a call of step() over n calls ending in a synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def _train_graph_case(case, encoder, batch, val, nms, tmp, card) -> None:
    """One case of [train graphs]: TRAIN_GRAPH_STEPS steps through the
    trainer's program and through the eager body of a second trainer from
    the same seeded state, bit-equal; the eval program against its eager
    body on each val batch, kernel 2 once a batch under replay; the A/B
    readings."""
    from yoloclip_tpu_torch.train import train_state as ts
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                    trace)
    t0 = time.perf_counter()
    tag, assigner, dtype, accum, ema = case
    cfg = _train_cfg(assigner=assigner, dtype=dtype, grad_accum_steps=accum,
                     ema_decay=ema, ema_warmup_steps=2, eval_with_nms=True,
                     batch_size=TRAIN_BS,
                     output_dir=os.path.join(tmp, 'train_graphs'))
    prog, eager = (YOLOCLIPTrainer(_seeded_model(cfg), encoder, cfg,
                                   device='cuda') for _ in range(2))
    arrays = prog._put_batch(batch)
    text = prog._encode_batch_text(batch['text_prompts'])
    sched = ts.make_onecycle_schedule(cfg.learning_rate, TRAIN_GRAPH_STEPS, 1)
    for i in range(TRAIN_GRAPH_STEPS):
        for t in (prog, eager):
            ts.set_learning_rate(t.state, sched(i))
        got = prog._train_step(prog.state, arrays, text)
        want = eager._train_step_eager(eager.state, arrays, text)
        require(all(torch.equal(got[k], want[k]) for k in want),
                f'[train graphs] {tag} step {i}: loss parts {got} vs the '
                f'eager body {want}')
    bad = _train_state_diff(prog.state, eager.state)
    require(not bad, f'[train graphs] {tag}: after {TRAIN_GRAPH_STEPS} steps '
            f'{len(bad)} tensors differ from the eager body\'s, e.g. '
            f'{bad[:3]}')
    n_state = (len(prog.model.state_dict()) + len(prog.state.ema or {})
               + sum(len(v) for v in prog.state.optimizer.state.values()))
    progs = [p for p in prog.programs.programs() if p.name == 'train_step']
    # the eval program: equal to its body on each batch, one NMS a batch
    for v in val:
        prog._eval_step(prog.state, prog._put_batch(v),
                        prog._encode_batch_text(v['text_prompts']))
    before = nms.launches
    for v in val:
        va = prog._put_batch(v)
        vt = prog._encode_batch_text(v['text_prompts'])
        got, want = (prog._eval_step(prog.state, va, vt),
                     prog._eval_step_eager(prog.state, va, vt))
        replays = nms.launches - before - 1      # the eager body's one
        before = nms.launches
        require(replays == 1, f'[train graphs] {tag}: an eval replay '
                f'launched kernel 2 {replays} times')
        require(all(torch.equal(got[i][k], want[i][k]) for i in (0, 1)
                    for k in want[i]),
                f'[train graphs] {tag}: the eval program differs from its '
                f'eager body')
    # readings: step ms and peak memory in turns, idle share, breakdown
    steps = {'eager': lambda: eager._train_step_eager(eager.state, arrays,
                                                      text),
             'program': lambda: prog._train_step(prog.state, arrays, text)}
    turns, peak = [], {}
    for k in ('eager', 'program', 'program', 'eager'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        turns.append(_steps_ms(steps[k], TRAIN_GRAPH_TIMED))
        peak[k] = max(peak.get(k, 0.0),
                      torch.cuda.max_memory_allocated() / 2 ** 30)
    log_dir = os.path.join(tmp, f'train_graphs_{tag.replace(" ", "_")}')
    with trace(log_dir) as prof:
        for k, step in steps.items():
            with annotate(f'{k} x{TRAIN_GRAPH_TRACED}'):
                for _ in range(TRAIN_GRAPH_TRACED):
                    step()
                torch.cuda.synchronize()
    summ = {k: device_summary(prof, span=f'{k} x{TRAIN_GRAPH_TRACED}')
            for k in steps}
    print(f'[train graphs] {tag} bs={TRAIN_BS} 640 px, deterministic: '
          f'{TRAIN_GRAPH_STEPS} steps through the program (the first its '
          f'eager warm-up) and {TRAIN_GRAPH_STEPS} through the eager body '
          f'from one seeded state, a new rate each step: loss parts and '
          f'all {n_state} state tensors (parameters, BatchNorm buffers, '
          f'EMA, optimizer moments) bit-equal; eval_with_nms program = its '
          f'eager body on {len(val)} batches, kernel 2 once a replay; step '
          f'ms (train step alone, batch and text on the card) in turns '
          f'eager {turns[0]:.2f}, program {turns[1]:.2f}, program '
          f'{turns[2]:.2f}, eager {turns[3]:.2f} (img/s '
          + ', '.join(f'{TRAIN_BS / t * 1e3:.1f}' for t in turns)
          + f'); device ms a step / idle share over {TRAIN_GRAPH_TRACED} '
          f'traced step(s) eager '
          f'{summ["eager"]["busy_ms"] / TRAIN_GRAPH_TRACED:.2f} / '
          f'{_share(summ["eager"]["idle_share"])}, program '
          f'{summ["program"]["busy_ms"] / TRAIN_GRAPH_TRACED:.2f} / '
          f'{_share(summ["program"]["idle_share"])}; peak GiB eager '
          f'{peak["eager"]:.2f}, program {peak["program"]:.2f}; warm-up '
          + ', '.join(f'{p.warmup_s:.3f}' for p in progs) + ' s, capture '
          + ', '.join(f'{p.capture_s:.3f}' for p in progs)
          + f' s; case seconds {time.perf_counter() - t0:.1f}  [{card}]')
    for k, sm in summ.items():            # [train breakdown] of each span
        total = sum(v[0] for v in sm['kernels'].values())
        print(f'[train breakdown] {tag} {k}, {TRAIN_GRAPH_TRACED} step(s): '
              f'host span {sm["span_ms"]:.2f} ms, device busy '
              f'{sm["busy_ms"]:.2f} ms, idle share '
              f'{_share(sm["idle_share"])}, '
              f'{sum(v[1] for v in sm["kernels"].values())} device '
              f'activities  [{card}]')
        for name, (ms, n) in sorted(sm['kernels'].items(),
                                    key=lambda kv: -kv[1][0])[:10]:
            print(f'[train breakdown]   {ms / TRAIN_GRAPH_TRACED:8.3f} ms  '
                  f'{n // TRAIN_GRAPH_TRACED:5d}x  {100 * ms / total:5.1f} %  '
                  f'{name[:110]}')
    if tag == RESUME_CASE:
        _train_graph_resume(tag, cfg, prog, eager, encoder, arrays, text,
                            tmp, card)


def _train_graph_resume(tag, cfg, prog, eager, encoder, arrays, text, tmp,
                        card) -> None:
    """Resume both trainers from a CPU trainer's checkpoint (the optimizer
    in the CPU's form: a float rate, capturable off, CPU step counters, as
    CPU runs and the trainers before the programs saved it), then
    RESUME_STEPS steps through a new program (its capture, then a replay)
    and through the eager body: bit-equal. The program trainer keeps its
    rate tensor, capturable on, its step counters fp32 on the card."""
    from yoloclip_tpu_torch.train import train_state as ts
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    from yoloclip_tpu_torch.utils.checkpoint import load_checkpoint
    card_path = os.path.join(tmp, 'train_graphs_card.pt')
    cpu_path = os.path.join(tmp, 'train_graphs_cpu.pt')
    eager.save(card_path)
    cpu = YOLOCLIPTrainer(_seeded_model(cfg, seed=1), encoder, cfg,
                          device='cpu')
    cpu.load(card_path)
    cpu.save(cpu_path)
    del cpu
    saved = load_checkpoint(cpu_path)['optimizer']['param_groups'][0]
    require(saved['capturable'] is False
            and not isinstance(saved['lr'], torch.Tensor),
            f'[train graphs] {tag}: the CPU trainer saved its optimizer in '
            f'the form capturable={saved["capturable"]}, lr '
            f'{type(saved["lr"]).__name__}')
    rate = prog.state.optimizer.param_groups[0]['lr']
    for t in (prog, eager):
        t.load(cpu_path)
    opt = prog.state.optimizer
    steps = [st['step'] for st in opt.state.values()]
    require(opt.param_groups[0]['lr'] is rate
            and opt.param_groups[0]['capturable'] is True
            and all(x.is_cuda and x.dtype == torch.float32 for x in steps),
            f'[train graphs] {tag}: resumed from the CPU trainer\'s '
            f'checkpoint, the optimizer is not in the card\'s form')
    sched = ts.make_onecycle_schedule(cfg.learning_rate, TRAIN_GRAPH_STEPS, 1)
    for i in range(RESUME_STEPS):
        for t in (prog, eager):
            ts.set_learning_rate(t.state, sched(i))
        got = prog._train_step(prog.state, arrays, text)
        want = eager._train_step_eager(eager.state, arrays, text)
        require(all(torch.equal(got[k], want[k]) for k in want),
                f'[train graphs] {tag} resumed step {i}: loss parts {got} '
                f'vs the eager body {want}')
    bad = _train_state_diff(prog.state, eager.state)
    require(not bad, f'[train graphs] {tag}: resumed, {len(bad)} tensors '
            f'differ from the eager body\'s, e.g. {bad[:3]}')
    print(f'[train graphs] {tag}: both trainers resumed from a CPU '
          f'trainer\'s checkpoint (capturable off, a float rate, CPU step '
          f'counters); the program trainer kept its rate tensor, capturable '
          f'on, {len(steps)} step counters fp32 on the card; '
          f'{RESUME_STEPS} steps through a new program (capture, replay) '
          f'bit-equal to the eager body  [{card}]')


def _memory_by_pool(dev: torch.device) -> str:
    """The caching allocator's segments on `dev` grouped by graph pool and
    stream: pool id (the live shared pool of `inference/program.py`
    marked 'shared', the default pool 'default'; other ids are retired
    pools or private ones), segments, reserved and allocated GiB."""
    from yoloclip_tpu_torch.inference import program
    live = program._shared.get(dev)
    live = tuple(live[0]) if live is not None else None
    groups = {}
    for seg in torch.cuda.memory_snapshot():
        if seg['device'] != dev.index:
            continue
        pool = tuple(seg.get('segment_pool_id', (0, 0)))
        g = groups.setdefault((pool, seg['stream']), [0, 0, 0])
        g[0] += 1
        g[1] += seg['total_size']
        g[2] += seg['allocated_size']
    parts = []
    for (pool, stream), (n, total, used) in sorted(
            groups.items(), key=lambda kv: -kv[1][1]):
        name = ('default' if pool == (0, 0)
                else 'shared' if pool == live else 'other')
        parts.append(f'{name} {pool} stream {stream:#x}: {n} segments, '
                     f'{total / 2 ** 30:.2f} GiB reserved, '
                     f'{used / 2 ** 30:.2f} allocated')
    return '; '.join(parts)


def _pool_growth(encoder, tmp: str, card: str) -> None:
    """The shared pool after each new program of a clean bf16 trainer
    over a training run's sequence of shapes: train batches at the class
    buckets of POOL_CLASSES, a partial last batch, an eval batch at 8
    classes (each with its prompts' encode programs)."""
    from yoloclip_tpu_torch.data.loader import device_prefetch
    from yoloclip_tpu_torch.inference import program
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    dev = torch.device('cuda', torch.cuda.current_device())
    cfg = _train_cfg(assigner='topk_center', dtype='bfloat16',
                     eval_with_nms=True, batch_size=TRAIN_BS,
                     output_dir=os.path.join(tmp, 'pool_growth'))
    t = YOLOCLIPTrainer(_seeded_model(cfg), encoder, cfg, device='cuda')
    shapes = ([('train', TRAIN_BS, c) for c in POOL_CLASSES]
              + [('train', POOL_LAST, POOL_CLASSES[0]),
                 ('eval', TRAIN_BS, POOL_CLASSES[0])])
    readings = [f'start {program.pool_bytes(dev) / 2 ** 30:.2f}']
    for i, (kind, n, classes) in enumerate(shapes):
        batch = next(device_prefetch(
            iter([_train_batch(n, 40 + i, classes=classes)]), 'cuda'))
        before = t.programs.count() + encoder.programs.count()
        arrays = t._put_batch(batch)
        text = t._encode_batch_text(batch['text_prompts'])
        step = t._train_step if kind == 'train' else t._eval_step
        step(t.state, arrays, text)
        torch.cuda.synchronize()
        new = t.programs.count() + encoder.programs.count() - before
        readings.append(f'{kind} B={n} C={text.shape[1]} (+{new}) '
                        f'{program.pool_bytes(dev) / 2 ** 30:.2f}')
    print(f'[train graphs] pool growth, clean bf16 640 px, one trainer '
          f'(shared pool GiB after each shape; +new programs, train or '
          f'eval and encode): ' + ', '.join(readings) + f'  [{card}]')


def _text_graphs(encoder, card) -> None:
    """The text tower's encode program against its eager body: the
    1203-class vocabulary (5 templates, 8192 token rows) and an online
    batch of ONLINE_PROMPTS prompts bit-equal, and the vocabulary build
    ms in turns eager, program, program, eager (the prompt cache cleared
    before each build)."""
    from yoloclip_tpu_torch.text.vocab import VocabularyBuilder
    builder = VocabularyBuilder(encoder)
    programs = encoder.programs

    def build(eager: bool, fn):
        encoder.programs = _EagerPrograms() if eager else programs
        encoder._cache.clear()
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3
        finally:
            encoder.programs = programs

    readings = {}
    for tag, fn in (('vocabulary', lambda: builder.build_online_vocabulary(
                        LVIS_NAMES)),
                    ('online', lambda: encoder(PROMPTS[:ONLINE_PROMPTS]))):
        build(False, fn)                  # captured
        runs = [build(e, fn) for e in (True, False, False, True)]
        require(all(torch.equal(r[0], runs[0][0]) for r in runs),
                f'[train graphs] text {tag}: the encode program differs '
                f'from its eager body')
        readings[tag] = [r[1] for r in runs]
    progs = programs.programs()
    print(f'[train graphs] text tower fp32: the {LVIS_C}-class vocabulary '
          f'(x5 templates) and {ONLINE_PROMPTS} online prompts through the '
          f'encode programs ('
          + ', '.join(f'{tuple(p.static[0].shape)} capture '
                      f'{p.capture_s:.3f} s' for p in progs)
          + ') bit-equal to the eager tower; ms in turns eager, program, '
          f'program, eager: vocabulary build '
          + ', '.join(f'{t:.1f}' for t in readings['vocabulary'])
          + f'; {ONLINE_PROMPTS} online prompts '
          + ', '.join(f'{t:.2f}' for t in readings['online'])
          + f'  [{card}]')


def phase_train_graphs(sim, nms, tmp: str, card: str) -> dict:
    """[train graphs]: the trainer's train and eval programs against their
    eager bodies for each TRAIN_GRAPH_CASES case, the text tower's encode
    program against its body, the graph pool, and a failing capture of a
    grad program; all under deterministic algorithms. Returns the launches
    of the phase, counted from 0."""
    from yoloclip_tpu_torch.data.loader import device_prefetch
    from yoloclip_tpu_torch.inference import program
    from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder
    t0 = time.perf_counter()
    encoder = CLIPTextEncoder(device='cuda', seed=0)
    batch = next(device_prefetch(iter([_train_batch(TRAIN_BS, 2)]), 'cuda'))
    val = list(device_prefetch(iter([_train_batch(TRAIN_BS, 3 + i)
                                     for i in range(EVAL_IMAGES
                                                    // TRAIN_BS)]),
                               'cuda'))
    dev = torch.device('cuda', torch.cuda.current_device())
    print(f'[train graphs] memory at the phase\'s start: '
          f'{_memory_by_pool(dev)}  [{card}]')
    _zero_counts(sim, nms)
    with _deterministic():
        for case in TRAIN_GRAPH_CASES:
            _train_graph_case(case, encoder, batch, val, nms, tmp, card)
            gc.collect()                  # the case's trainers and graphs
            torch.cuda.empty_cache()
        t_text = time.perf_counter()
        _text_graphs(encoder, card)
    torch.cuda.synchronize()
    launches = _counts(sim, nms)
    t_pool = time.perf_counter()
    _pool_growth(encoder, tmp, card)
    gc.collect()                          # the trainer's graphs
    torch.cuda.empty_cache()
    # before the failed capture below, which retires the device's pool
    pool_gib = program.pool_bytes(dev) / 2 ** 30
    print(f'[train graphs] memory after the cases, the text programs and '
          f'the pool growth (their trainers freed, the encoder\'s programs '
          f'alive): {_memory_by_pool(dev)}  [{card}]')
    raised = _forced_sync_raises(grad=True)
    require(raised, '[train graphs] a grad program\'s body that syncs did '
            'not raise at capture naming its program, or a capture after '
            'it failed')
    reserved = torch.cuda.memory_reserved(dev) / 2 ** 30
    del encoder
    gc.collect()                          # the retired pool goes back
    torch.cuda.empty_cache()
    print(f'[train graphs] memory after the failed capture and the '
          f'encoder freed: {_memory_by_pool(dev)}  [{card}]')
    print(f'[train graphs] text seconds {t_pool - t_text:.1f}, pool growth '
          f'seconds {time.perf_counter() - t_pool:.1f}; '
          f'a grad program calling .item() raised at capture '
          f'and the next capture worked; graph pool on {dev} '
          f'{pool_gib:.2f} GiB (of {reserved:.2f} GiB reserved; '
          f'{torch.cuda.memory_reserved(dev) / 2 ** 30:.2f} GiB after the '
          f'phase); launches {launches}; phase seconds '
          f'{time.perf_counter() - t0:.1f}  [{card}]')
    require(launches['nms'] > 0, '[train graphs] no kernel 2 launch')
    return launches


# ---------------------------------------------------------------------------
# Data parallelism (yoloclip_tpu_torch/parallel/) on the one card. Two
# ranks share cuda:0 through gloo (NCCL refuses two ranks on one device);
# one rank runs through NCCL. Two ranks on one card show correctness, not
# scaling: their step times include gloo's host round trips of every
# gradient bucket, and multi-card scaling is not measured.
# ---------------------------------------------------------------------------

# Global batch of the [ddp] steps (8 a rank); (tag, assigner, dtype).
DDP_BS = 16
DDP_STEPS = (('compat fp32', 'compat', 'float32'),
             ('clean bf16', 'topk_center', 'bfloat16'))
DDP_TIMED = 3
# 2 ranks against 1 process, both on the card. fp32: PR 8's card-vs-
# float64 gate (TRAIN_*): the two runs differ by rounding only (the global
# statistics combined per rank, the loss sums split in two). bf16: every
# conv input is rounded to 8 bits, so where the two runs' statistics
# differ by rounding some of those roundings flip by one bf16 ulp, and a
# small gradient tensor (e.g. a text projection's bias) can move by its
# own size: loss parts are held within 2^-8 relative; gradients (relative
# L2 over all of them) and buffers are held against the fp32 step: the
# 2-rank bf16 step no further from it than DDP_BF16_FACTOR x the 1-process
# bf16 step.
DDP_TOL = {'float32': (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_BUF_ATOL),
           'bfloat16': (2.0 ** -8, None, None)}
DDP_BF16_FACTOR = 1.5
DDP_TIMEOUT_S = 600


def _ddp_batch():
    """The [ddp] global batch: DDP_BS synthetic 640 px images and their
    (DDP_BS, 128, 512) text, 80 prompts a sample (the rest zero)."""
    batch = _train_batch(DDP_BS, 2)
    g = torch.Generator().manual_seed(2)
    text = torch.randn((DDP_BS, 128, EMBED), generator=g)
    text[:, 80:] = 0.0
    arrays = {k: batch[k] for k in ('images', 'boxes', 'class_ids',
                                    'valid_mask')}
    return arrays, text, batch['text_prompts']


def _params_equal_over_ranks(model, group) -> bool:
    import torch.distributed as dist
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    lo, hi = flat.clone(), flat.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(lo, hi))


def _ddp_rank(rank: int, world: int, rendezvous: str, out_dir: str,
              backend: str, kind: str = 'ddp') -> None:
    """One rank of the [ddp] phase on cuda:0: each DDP_STEPS step on its
    rows of the global batch through the eager DDP route (world 1: the
    fp32 step only), then with two ranks `evaluate` with NMS (kernel 2) on
    DDP_EVAL_IMAGES images and `make_sharded_inference` (its eager route)
    with the folded scoring (kernel 1) on its rows; over gloo, the program
    route must refuse the card and the trainer take the eager route. kind
    'graphs':
    a rank of [ddp graphs] instead (`_ddp_graph_rank`), NCCL on cuda:{rank};
    kind 'split': a rank of [split ranks] (`_split_rank`). Writes
    out_dir/rank{rank}.pt."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim
    from yoloclip_tpu_torch.parallel import multihost
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    from yoloclip_tpu_torch.parallel.train_step import (
        make_sharded_inference, make_sharded_train_step, place_batch)
    from yoloclip_tpu_torch.train import train_state as ts
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    multihost.initialize(f'file://{rendezvous}', world, rank,
                         device=f'cuda:{rank}' if backend == 'nccl'
                         else 'cuda:0', backend=backend,
                         timeout_s=DDP_TIMEOUT_S)
    if kind == 'split':
        # a rank that hangs prints every thread's stack and exits
        faulthandler.dump_traceback_later(SPLIT_TIMEOUT_S, exit=True)
        out = _split_rank(rank, world, out_dir, backend)
        torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
        multihost.shutdown()
        faulthandler.cancel_dump_traceback_later()
        return
    mesh = create_mesh()
    if kind == 'graphs':
        out = _ddp_graph_rank(rank, world, mesh, nms, out_dir)
        torch.save(dict(out, mesh=repr(mesh)),
                   os.path.join(out_dir, f'rank{rank}.pt'))
        multihost.shutdown()
        return
    out = {'backend': backend, 'mesh': repr(mesh)}
    arrays, text, prompts = _ddp_batch()
    for tag, assigner, dtype in DDP_STEPS[:1 if world == 1 else None]:
        cfg = _train_cfg(assigner=assigner, dtype=dtype, batch_size=DDP_BS)
        state = ts.create_train_state(_seeded_model(cfg), cfg, 'cuda:0')
        ts.set_learning_rate(state, cfg.learning_rate)
        if backend == 'gloo':   # gloo's collectives cannot be captured
            try:
                make_sharded_train_step(cfg, mesh)(state)
                out['gloo_program'] = 'built'
            except RuntimeError as e:
                out['gloo_program'] = str(e)
        step = make_sharded_train_step(cfg, mesh, eager=True)(state)
        local = place_batch(dict(arrays, text=text), mesh)
        t = local.pop('text')
        parts = {k: float(v) for k, v in step(state, local, t).items()}
        res = {'parts': parts,
               'identical': _params_equal_over_ranks(state.model,
                                                     mesh.group)}
        if rank == 0:   # copies: the timed steps below go on in place
            res['grads'] = {k: p.grad.detach().to('cpu', copy=True)
                            for k, p in state.model.named_parameters()}
            res['state'] = {k: v.detach().to('cpu', copy=True) for k, v in
                            state.model.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DDP_TIMED):
            step(state, local, t)
        torch.cuda.synchronize()
        res['ms'] = (time.perf_counter() - t0) / DDP_TIMED * 1e3
        out[tag] = res
        del step, state
    if world > 1:
        from yoloclip_tpu_torch.ops.nms import batched_nms
        from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder
        cfg = _train_cfg(eval_with_nms=True, batch_size=DDP_BS,
                         output_dir=os.path.join(out_dir, 'train'))
        trainer = YOLOCLIPTrainer(_seeded_model(cfg),
                                  CLIPTextEncoder(device='cuda:0', seed=0),
                                  cfg, mesh=mesh)
        out['trainer_eager'] = (
            trainer._train_step is trainer._train_step_eager
            and trainer._eval_step is trainer._eval_step_eager)
        val = [_train_batch(DDP_BS, 3 + i)
               for i in range(EVAL_IMAGES // DDP_BS)]
        nms.launches = sim.launches = sim.launches_bf16 = 0
        t0 = time.perf_counter()
        out['eval'] = trainer.evaluate(val)
        out['eval_ms'] = (time.perf_counter() - t0) * 1e3
        out['eval_nms_launches'] = nms.launches
        # kernel 1 on this rank's rows: the folded scoring over one
        # shared vocabulary, against the model's own unfolded scores
        vocab = torch.randn((80, EMBED), generator=torch.Generator(
            ).manual_seed(4))
        vocab = (vocab / vocab.norm(dim=-1, keepdim=True)).cuda()
        model = trainer.model.eval()
        # gloo on the card: the forward's eager route
        run = make_sharded_inference(model, mesh, eager=True)
        images = torch.from_numpy(val[0]['images'])
        launched = {}
        _zero_counts(sim, nms)
        (fused,) = run(images, vocab, fused_scores=True)
        det = batched_nms(fused['boxes'], fused['scores'], fused['class_ids'],
                          0.25, 0.45, topk=1024, max_detections=100)
        torch.cuda.synchronize()
        launched.update(_counts(sim, nms))
        (plain,) = run(images, vocab)
        out['infer'] = {
            'launches': launched, 'rows': int(fused['scores'].shape[0]),
            'score_diff': float((fused['scores'] - plain['scores'])
                                .abs().max()),
            'finite': bool(torch.isfinite(det['scores']).all())}
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    multihost.shutdown()


def _run_ranks(world: int, backend: str, out_dir: str,
               kind: str = 'ddp') -> list:
    """Spawn `world` [ddp] ranks (kind 'graphs': [ddp graphs] ranks,
    'split': [split ranks] ranks), wait for them (failing the run past
    DDP_TIMEOUT_S, SPLIT_TIMEOUT_S for 'split', or on any rank's error)
    and load their results."""
    import torch.multiprocessing as mp
    rdv = os.path.join(out_dir, f'rendezvous_{backend}_{world}_{kind}')
    ctx = mp.start_processes(_ddp_rank, args=(world, rdv, out_dir, backend,
                                              kind),
                             nprocs=world, join=False, start_method='spawn')
    deadline = time.perf_counter() + (SPLIT_TIMEOUT_S + 30 if kind == 'split'
                                      else DDP_TIMEOUT_S + 120)
    try:
        while not ctx.join(timeout=5):
            require(time.perf_counter() < deadline,
                    f'[ddp] {backend} ranks did not finish in time')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)]


def _single_card_step(tag, assigner, dtype):
    """The 1-process step on the card over the [ddp] global batch: (loss
    parts, gradients, state dict, the step's ms over DDP_TIMED more)."""
    from yoloclip_tpu_torch.train import train_state as ts
    cfg = _train_cfg(assigner=assigner, dtype=dtype, batch_size=DDP_BS)
    state = ts.create_train_state(_seeded_model(cfg), cfg, 'cuda')
    ts.set_learning_rate(state, cfg.learning_rate)
    arrays, text, _ = _ddp_batch()
    b = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    step = ts.make_train_step(cfg)
    parts = {k: float(v) for k, v in step(state, b, text.cuda()).items()}
    grads = {k: p.grad.detach().to('cpu', copy=True)
             for k, p in state.model.named_parameters()}
    sd = {k: v.detach().to('cpu', copy=True)
          for k, v in state.model.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DDP_TIMED):
        step(state, b, text.cuda())
    torch.cuda.synchronize()
    return parts, grads, sd, (time.perf_counter() - t0) / DDP_TIMED * 1e3


def _grad_err(got, want):
    """(worst relative L2 of a gradient tensor, its name; relative L2 of
    all of them together), over tensors above 1e-6 of the largest norm."""
    top = max(float(g.norm()) for g in want.values())
    worst, name, num, den = 0.0, '', 0.0, 0.0
    for k, g in want.items():
        if float(g.norm()) > 1e-6 * top:
            d = float((got[k] - g).norm())
            num, den = num + d * d, den + float(g.norm()) ** 2
            if d / float(g.norm()) > worst:
                worst, name = d / float(g.norm()), k
    return worst, name, (num / den) ** 0.5


def _buf_err(got, want):
    return max((got[k] - v).abs().max().item() for k, v in want.items()
               if k.endswith(('running_mean', 'running_var')))


def _compare_step(tag, assigner, dtype, got, want, card, label='[ddp]',
                  ranks='2 ranks (gloo, both on cuda:0: correctness, not '
                        'scaling)'):
    """A rank's step against the 1-process step: loss parts, gradients,
    BatchNorm buffers (bf16: both against the fp32 step, DDP_TOL); its
    parameters against AdamW applied on the card to its own (all-reduced)
    gradients from the seeded state."""
    from yoloclip_tpu_torch.train import train_state as ts
    parts, grads, sd, ms = want
    loss_tol, grad_tol, buf_tol = DDP_TOL[dtype]
    loss_err = max(abs(got['parts'][k] - v) / max(abs(v), 1e-12)
                   for k, v in parts.items() if v != 0)
    grad_err, worst, grad_all = _grad_err(got['grads'], grads)
    buf_err = _buf_err(got['state'], sd)
    extra = ''
    if grad_tol is None:   # bf16: against the fp32 step
        _, f_grads, f_sd, _ = _single_card_step(tag, assigner, 'float32')
        grad_all = _grad_err(got['grads'], f_grads)[2]
        grad_tol = DDP_BF16_FACTOR * _grad_err(grads, f_grads)[2]
        buf_err = _buf_err(got['state'], f_sd)
        buf_tol = DDP_BF16_FACTOR * _buf_err(sd, f_sd)
        extra = (' (bf16: gradients over all tensors and buffers against '
                 'the fp32 step, tolerances '
                 f'{DDP_BF16_FACTOR:g}x the 1-process bf16 step\'s)')
    cfg = _train_cfg(dtype=dtype)
    ref = _seeded_model(cfg).to('cuda', torch.float32)
    opt = ts.make_optimizer(cfg, ref.parameters())
    for k, p in ref.named_parameters():
        p.grad = got['grads'][k].cuda()
    opt.step()
    param_err = max((got['state'][k] - p.detach().cpu()).abs().max().item()
                    for k, p in ref.named_parameters())
    print(f'{label} {tag} bs={DDP_BS} 640 px, {ranks} '
          f'vs 1 process on the card{extra}: loss parts max rel '
          f'{loss_err:.3e} (tol {loss_tol:g}); gradients rel L2 over all '
          f'{grad_all:.3e} (tol {grad_tol:.3e}), worst tensor {grad_err:.3e} '
          f'({worst}); BatchNorm buffers max abs {buf_err:.3e} '
          f'(tol {buf_tol:.3e}); parameters vs AdamW on the ranks\' gradients '
          f'max abs {param_err:.3e} (tol {TRAIN_PARAM_ATOL:g}); ranks\' '
          f'parameters identical={got["identical"]}; step {got["ms"]:.2f} '
          f'ms a rank vs {ms:.2f} ms in one process  [{card}]')
    require(got['identical'], f'{label} {tag}: the ranks diverged')
    require(loss_err <= loss_tol, f'{label} {tag}: loss parts')
    require((grad_err if dtype == 'float32' else grad_all) <= grad_tol,
            f'{label} {tag}: gradients')
    require(buf_err <= buf_tol, f'{label} {tag}: BatchNorm buffers')
    require(param_err <= TRAIN_PARAM_ATOL, f'{label} {tag}: AdamW')


def phase_ddp(sim, nms, tmp: str, card: str) -> dict:
    """[ddp]: the 2-rank gloo steps and the 1-rank NCCL step against the
    1-process step on the card; evaluate and sharded inference under two
    ranks. Returns the ranks' kernel launches (evaluate, inference)."""
    out_dir = os.path.join(tmp, 'ddp')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    r0, r1 = _run_ranks(2, 'gloo', out_dir)
    secs = time.perf_counter() - t0
    print(f'[ddp] two gloo ranks on cuda:0 ({r0["mesh"]}) ran in {secs:.1f} '
          f's with their start-up; the program route over gloo on the card '
          f'refused: {r0["gloo_program"]!r}; the trainer took the eager '
          f'route: {r0["trainer_eager"]}')
    for r in (r0, r1):
        require('cannot capture' in r['gloo_program'],
                '[ddp] a program over gloo on the card did not raise')
        require(r['trainer_eager'], '[ddp] the trainer over gloo on the '
                'card did not take the eager route')
    for tag, assigner, dtype in DDP_STEPS:
        require(r0[tag]['parts'] == r1[tag]['parts'],
                f'[ddp] {tag}: the ranks report other losses')
        r0[tag]['identical'] &= r1[tag]['identical']
        _compare_step(tag, assigner, dtype, r0[tag],
                      _single_card_step(tag, assigner, dtype), card)

    # one rank through NCCL: the step without DDP
    (n0,) = _run_ranks(1, 'nccl', out_dir)
    tag, assigner, dtype = DDP_STEPS[0]
    parts, grads, sd, ms = _single_card_step(tag, assigner, dtype)
    got = n0[tag]
    loss_err = max(abs(got['parts'][k] - v) / max(abs(v), 1e-12)
                   for k, v in parts.items() if v != 0)
    grad_err = max(float((got['grads'][k] - g).norm() / g.norm())
                   for k, g in grads.items() if float(g.norm()) > 0)
    same = all(torch.equal(got['grads'][k], g) for k, g in grads.items())
    print(f'[ddp] {tag}: 1 NCCL rank vs the step without DDP: loss parts '
          f'max rel {loss_err:.3e}, gradients max rel L2 {grad_err:.3e}, '
          f'bit-identical gradients={same}; step {got["ms"]:.2f} ms vs '
          f'{ms:.2f} ms  [{card}]')
    require(loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL,
            '[ddp] the NCCL rank differs from the step without DDP')

    # evaluate + sharded inference under the two gloo ranks
    e0, e1 = r0['eval'], r1['eval']
    i0, i1 = r0['infer'], r1['infer']
    print(f'[ddp] evaluate eval_with_nms=True on {EVAL_IMAGES} images, 2 '
          f'ranks: rank 0 {e0}, rank 1 {e1}; {r0["eval_ms"]:.1f} / '
          f'{r1["eval_ms"]:.1f} ms; NMS kernel launches rank 0 '
          f'{r0["eval_nms_launches"]}, rank 1 {r1["eval_nms_launches"]}')
    print(f'[ddp] make_sharded_inference, folded scoring + NMS on each '
          f'rank\'s {i0["rows"]} rows: launches rank 0 {i0["launches"]}, '
          f'rank 1 {i1["launches"]}; folded vs unfolded scores max diff '
          f'{i0["score_diff"]:.3e} / {i1["score_diff"]:.3e} (tol '
          f'{XDEV_SCORE_ATOL:g})')
    require(e0 == e1, '[ddp] the ranks computed different eval metrics')
    per_rank = EVAL_IMAGES // DDP_BS
    for r in (r0, r1):
        i = r['infer']
        require(r['eval_nms_launches'] == per_rank,
                '[ddp] evaluate did not launch kernel 2 once a batch')
        require(i['launches']['similarity'] > 0 and i['launches']['nms'] > 0,
                '[ddp] a rank did not launch kernels 1 and 2')
        require(i['score_diff'] <= XDEV_SCORE_ATOL and i['finite'],
                '[ddp] folded scoring on a rank')
    launches = {k: 0 for k in ('similarity', 'similarity_bf16', 'nms')}
    for r in (r0, r1):
        for k, v in r['infer']['launches'].items():
            launches[k] += v
        launches['nms'] += r['eval_nms_launches']
    return launches


# ---------------------------------------------------------------------------
# [ddp graphs]: the sharded train and eval steps as programs, CUDA graphs
# holding NCCL's collectives, against the eager DDP route; under
# deterministic algorithms, so that each pair must agree bit for bit.
# ---------------------------------------------------------------------------

# (tag, assigner, dtype, ema_decay) at the [ddp] global batch
DDP_GRAPH_CASES = (('compat fp32 EMA', 'compat', 'float32', 0.9999),
                   ('clean bf16', 'topk_center', 'bfloat16', 0.0))
DDP_GRAPH_STEPS = 3       # steps through the program and the eager route


def _ddp_graph_trainers(cfg, mesh):
    """(program trainer, eager trainer) over `mesh` from one seeded
    state; the first must run its steps as programs."""
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    prog, eager = (YOLOCLIPTrainer(_seeded_model(cfg), None, cfg, mesh=mesh)
                   for _ in range(2))
    require(prog._train_step is not prog._train_step_eager
            and prog._eval_step is not prog._eval_step_eager,
            '[ddp graphs] the trainer over NCCL did not build programs')
    return prog, eager


def _ddp_graph_steps(tag, prog, eager, arrays, text, steps) -> None:
    """`steps` steps through prog's program and eager's DDP route, a new
    rate each: loss parts and every state tensor bit-equal."""
    from yoloclip_tpu_torch.train import train_state as ts
    sched = ts.make_onecycle_schedule(prog.cfg.learning_rate, steps, 1)
    for i in range(steps):
        for t in (prog, eager):
            ts.set_learning_rate(t.state, sched(i))
        got = prog._train_step(prog.state, arrays, text)
        want = eager._train_step_eager(eager.state, arrays, text)
        require(all(torch.equal(got[k], want[k]) for k in want),
                f'[ddp graphs] {tag} step {i}: loss parts {got} vs the '
                f'eager DDP route {want}')
    bad = _train_state_diff(prog.state, eager.state)
    require(not bad, f'[ddp graphs] {tag}: after {steps} steps {len(bad)} '
            f'tensors differ from the eager DDP route\'s, e.g. {bad[:3]}')


def _ddp_graph_case(case, mesh, nms, arrays, text, val, out_dir) -> dict:
    """One case of the one-rank [ddp graphs]: DDP_GRAPH_STEPS steps, the
    eval program (NMS) against the eager eval step on each val batch,
    kernel 2 once a replay; the readings (step ms in turns, device ms and
    idle share of a traced step, peak GiB, capture s, pool GiB)."""
    from yoloclip_tpu_torch.inference import program
    from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                    trace)
    tag, assigner, dtype, ema = case
    t0 = time.perf_counter()
    cfg = _train_cfg(assigner=assigner, dtype=dtype, ema_decay=ema,
                     ema_warmup_steps=2, eval_with_nms=True,
                     batch_size=DDP_BS, output_dir=out_dir)
    prog, eager = _ddp_graph_trainers(cfg, mesh)
    a = prog._put_batch(arrays)
    t = text.to(prog.device)
    _ddp_graph_steps(tag, prog, eager, a, t, DDP_GRAPH_STEPS)
    vals = [prog._put_batch(v) for v in val]
    for v in vals:                        # the eval programs' first calls
        prog._eval_step(prog.state, v, t)
    before, replays = nms.launches, []
    for v in vals:
        got = prog._eval_step(prog.state, v, t)
        want = prog._eval_step_eager(prog.state, v, t)
        replays.append(nms.launches - before - 1)   # the eager step's one
        before = nms.launches
        require(all(torch.equal(got[i][k], want[i][k]) for i in (0, 1)
                    for k in want[i]),
                f'[ddp graphs] {tag}: the eval program differs from the '
                f'eager eval step')
    require(replays == [1] * len(vals), f'[ddp graphs] {tag}: eval replays '
            f'launched kernel 2 {replays} times')
    steps = {'eager': lambda: eager._train_step_eager(eager.state, a, t),
             'program': lambda: prog._train_step(prog.state, a, t)}
    turns, peak = [], {}
    for k in ('eager', 'program', 'program', 'eager'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        turns.append(_steps_ms(steps[k], TRAIN_GRAPH_TIMED))
        peak[k] = max(peak.get(k, 0.0),
                      torch.cuda.max_memory_allocated() / 2 ** 30)
    with trace(os.path.join(out_dir, 'trace')) as prof:
        for k, step in steps.items():
            with annotate(k):
                step()
                torch.cuda.synchronize()
    summ = {k: device_summary(prof, span=k) for k in steps}
    progs = [p for p in prog.programs.programs()
             if p.name in ('train_step', 'eval_step')]
    return {'turns': turns, 'peak': peak, 'replays': replays,
            'top': _top_kernels(summ['program']),
            'busy': {k: v['busy_ms'] for k, v in summ.items()},
            'idle': {k: v['idle_share'] for k, v in summ.items()},
            'capture': {p.name: p.capture_s for p in progs},
            'warmup': {p.name: p.warmup_s for p in progs},
            'pool': program.pool_bytes(prog.device) / 2 ** 30,
            'seconds': time.perf_counter() - t0}


def _ddp_graph_two(rank: int, mesh, arrays, text, out_dir: str) -> dict:
    """The two-rank [ddp graphs] check (see `_ddp_graph_rank`)."""
    from yoloclip_tpu_torch.parallel.train_step import place_batch
    from yoloclip_tpu_torch.train import train_state as ts
    tag, assigner, dtype = DDP_STEPS[0]
    cfg = _train_cfg(assigner=assigner, dtype=dtype, batch_size=DDP_BS,
                     output_dir=out_dir)
    prog, eager = _ddp_graph_trainers(cfg, mesh)
    for t in (prog, eager):
        ts.set_learning_rate(t.state, cfg.learning_rate)
    local = place_batch(dict(arrays, text=text), mesh)
    t = local.pop('text')
    a = prog._put_batch(local)
    parts = prog._train_step(prog.state, a, t)
    want = eager._train_step_eager(eager.state, a, t)
    res = {'parts': {k: float(v) for k, v in parts.items()},
           'equal': (all(torch.equal(parts[k], want[k]) for k in want)
                     and not _train_state_diff(prog.state,
                                               eager.state)),
           'identical': _params_equal_over_ranks(prog.model,
                                                 mesh.group)}
    if rank == 0:   # the eager route's gradients: a replay leaves none
        res['grads'] = {k: p.grad.detach().to('cpu', copy=True)
                        for k, p in eager.model.named_parameters()}
        res['state'] = {k: v.detach().to('cpu', copy=True) for k, v in
                        prog.model.state_dict().items()}
    res['ms'] = _steps_ms(lambda: prog._train_step(prog.state, a, t),
                          TRAIN_GRAPH_TIMED)
    return res


def _synced_bn_reading(mesh, arrays, text, out_dir: str) -> dict:
    """The clean bf16 train program on one rank with every BatchNorm
    synced over the (1-rank) data group, the path that two or more data
    ranks take (`set_batchnorm_group`): its cost on one card beside the
    plain module's, without any traffic between cards. Step ms in two
    turns, device ms, idle share and the top device activities of one
    traced step."""
    from yoloclip_tpu_torch.parallel.train_step import set_batchnorm_group
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    from yoloclip_tpu_torch.utils.profiling import device_summary, trace
    _, assigner, dtype, ema = DDP_GRAPH_CASES[1]
    cfg = _train_cfg(assigner=assigner, dtype=dtype, ema_decay=ema,
                     batch_size=DDP_BS, output_dir=out_dir)
    tr = YOLOCLIPTrainer(_seeded_model(cfg), None, cfg, mesh=mesh)
    n = set_batchnorm_group(tr.model, mesh.group)
    a = tr._put_batch(arrays)
    t = text.to(tr.device)

    def step():
        tr._train_step(tr.state, a, t)

    step()                                # the capture
    turns = [_steps_ms(step, TRAIN_GRAPH_TIMED) for _ in range(2)]
    with trace(os.path.join(out_dir, 'trace_synced')) as prof:
        step()
        torch.cuda.synchronize()
    summ = device_summary(prof)
    return {'n': n, 'turns': turns, 'busy': summ['busy_ms'],
            'idle': summ['idle_share'], 'top': _top_kernels(summ)}


def _top_kernels(summary: dict, n: int = 6) -> list:
    """The n device activities of a `device_summary` with the most time:
    (name, ms, count)."""
    return [(name[:70], ms, k) for name, (ms, k) in sorted(
        summary['kernels'].items(), key=lambda kv: -kv[1][0])[:n]]


def _ddp_graph_rank(rank: int, world: int, mesh, nms, out_dir: str) -> dict:
    """One NCCL rank of [ddp graphs] on cuda:{rank}, under deterministic
    algorithms. One rank: each DDP_GRAPH_CASES case (`_ddp_graph_case`).
    Two: the compat fp32 step on the rank's rows of the [ddp] global
    batch through the program and through the eager route (bit-equal:
    each average is one sum of two values; the eager route's gradients,
    the program's state). Two or more: the clean bf16 program's step ms
    at DDP_BS rows a rank in turns with the eager route, and rank 0's
    device time of one traced step of each."""
    from yoloclip_tpu_torch.parallel.train_step import place_batch
    from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                    trace)
    out_dir = os.path.join(out_dir, f'rank{rank}_{world}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arrays, text, _ = _ddp_batch()
    out = {'nms': 0}
    with _deterministic():
        if world == 1:
            val = [{k: v for k, v in _train_batch(DDP_BS, 3 + i).items()
                    if k != 'text_prompts'}
                   for i in range(EVAL_IMAGES // DDP_BS)]
            nms.launches = 0
            for case in DDP_GRAPH_CASES:
                out[case[0]] = _ddp_graph_case(case, mesh, nms, arrays,
                                               text, val, out_dir)
                gc.collect()
                torch.cuda.empty_cache()
            out['nms'] = nms.launches
            out['synced_bn'] = _synced_bn_reading(mesh, arrays, text,
                                                  out_dir)
            return out
        if world == 2:
            out[DDP_STEPS[0][0]] = _ddp_graph_two(rank, mesh, arrays, text,
                                                  out_dir)
        # weak scaling: DDP_BS rows a rank, as the one card's program
        _, assigner, dtype = DDP_STEPS[1]
        n = DDP_BS * world
        cfg = _train_cfg(assigner=assigner, dtype=dtype, batch_size=n,
                         output_dir=out_dir)
        prog, eager = _ddp_graph_trainers(cfg, mesh)
        big = {k: v for k, v in _train_batch(n, 5).items()
               if k != 'text_prompts'}
        big['text'] = torch.randn((n, 128, EMBED),
                                  generator=torch.Generator().manual_seed(5))
        local = place_batch(big, mesh)
        t = local.pop('text')
        a = prog._put_batch(local)
        steps = {'eager': lambda: eager._train_step_eager(eager.state, a, t),
                 'program': lambda: prog._train_step(prog.state, a, t)}
        for step in steps.values():       # the capture, DDP's construction
            step()
        out['scaling'] = {'rows': int(a['images'].shape[0]), 'turns': [
            _steps_ms(steps[k], TRAIN_GRAPH_TIMED)
            for k in ('eager', 'program', 'program', 'eager')]}
        with trace(os.path.join(out_dir, 'trace')) as prof:
            for k, step in steps.items():
                with annotate(k):
                    step()
                    torch.cuda.synchronize()
        summ = {k: device_summary(prof, span=k) for k in steps}
        out['scaling'].update(
            busy={k: v['busy_ms'] for k, v in summ.items()},
            idle={k: v['idle_share'] for k, v in summ.items()},
            top=_top_kernels(summ['program']))
    return out


def _tops(top: list) -> str:
    return ', '.join(f'{name} {ms:.2f} ms x{k}' for name, ms, k in top)


def phase_ddp_graphs(sim, nms, tmp: str, card: str) -> dict:
    """[ddp graphs]: one NCCL rank on cuda:0 runs the sharded train and
    eval steps as programs against the eager DDP route
    (`_ddp_graph_rank`); with two cards or more, one NCCL rank a card
    against the 1-process step at [ddp]'s tolerances and the per-rank step
    ms. Returns the phase's kernel launches (kernel 2 in the eval
    programs), counted from 0."""
    out_dir = os.path.join(tmp, 'ddp_graphs')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    (r,) = _run_ranks(1, 'nccl', out_dir, kind='graphs')
    secs = time.perf_counter() - t0
    for tag, *_ in DDP_GRAPH_CASES:
        c = r[tag]
        e, p = c['turns'][0], c['turns'][1]
        print(f'[ddp graphs] {tag} bs={DDP_BS} 640 px, 1 NCCL rank on cuda:0 '
              f'({r["mesh"]}), deterministic: {DDP_GRAPH_STEPS} steps '
              f'through the train program (the first its eager warm-up) and '
              f'{DDP_GRAPH_STEPS} through the eager DDP route from one '
              f'seeded state, a new rate each step: loss parts and every '
              f'state tensor bit-equal; eval_with_nms program = the eager '
              f'eval step on {len(c["replays"])} batches, kernel 2 '
              f'{c["replays"]} a replay; step ms in turns eager, program, '
              f'program, eager ' + ', '.join(f'{x:.2f}' for x in c['turns'])
              + f' (program/eager {p / e:.3f}); device ms / idle share of '
              f'one traced step eager {c["busy"]["eager"]:.2f} / '
              f'{_share(c["idle"]["eager"])}, program '
              f'{c["busy"]["program"]:.2f} / {_share(c["idle"]["program"])};'
              f' peak GiB eager {c["peak"]["eager"]:.2f}, program '
              f'{c["peak"]["program"]:.2f}; warm-up s ' + ', '.join(
                  f'{k} {v:.3f}' for k, v in c['warmup'].items())
              + '; capture s ' + ', '.join(
                  f'{k} {v:.3f}' for k, v in c['capture'].items())
              + f'; graph pool {c["pool"]:.2f} GiB; case seconds '
              f'{c["seconds"]:.1f}  [{card}]')
    q, plain = r['synced_bn'], r[DDP_GRAPH_CASES[1][0]]
    print(f'[ddp graphs] clean bf16 program with its {q["n"]} BatchNorms '
          f'synced over the 1-rank group (the path of two or more data '
          f'ranks, no traffic between cards): step ms '
          + ', '.join(f'{x:.2f}' for x in q['turns'])
          + f' vs the plain module\'s {plain["turns"][1]:.2f}, '
          f'{plain["turns"][2]:.2f}; device ms / idle share of one traced '
          f'step {q["busy"]:.2f} / {_share(q["idle"])} vs '
          f'{plain["busy"]["program"]:.2f} / '
          f'{_share(plain["idle"]["program"])}; top device activities '
          + _tops(q['top']) + '; the plain module\'s '
          + _tops(plain['top']) + f'  [{card}]')
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f'[ddp graphs] ran 1 NCCL rank on the one card ({secs:.1f} s '
              f'with its start-up); the several-card check needs two cards '
              f'or more  [{card}]')
        return {'nms': r['nms']}
    tag, assigner, dtype = DDP_STEPS[0]
    one = r[DDP_GRAPH_CASES[1][0]]['turns']
    for world in sorted({2, cards}):
        t1 = time.perf_counter()
        ranks = _run_ranks(world, 'nccl', out_dir, kind='graphs')
        secs_n = time.perf_counter() - t1
        if world == 2:
            for q in ranks:
                require(q[tag]['equal'], f'[ddp graphs] {tag}: a rank\'s '
                        f'program differs from its eager DDP route')
                require(q[tag]['parts'] == ranks[0][tag]['parts'],
                        f'[ddp graphs] {tag}: the ranks report other '
                        f'losses')
            got = dict(ranks[0][tag],
                       identical=all(q[tag]['identical'] for q in ranks))
            _compare_step(tag, assigner, dtype, got,
                          _single_card_step(tag, assigner, dtype), card,
                          label='[ddp graphs]',
                          ranks='2 NCCL ranks (one card each, programs '
                                'bit-equal to the eager DDP route)')
        print(f'[ddp graphs] ran {world} NCCL ranks, one card each '
              f'({secs_n:.1f} s with their start-up): clean bf16 at '
              f'{ranks[0]["scaling"]["rows"]} rows a rank, deterministic, '
              f'step ms a rank in turns eager, program, program, eager: '
              + '; '.join(f'rank {i} ' + ', '.join(
                  f'{x:.2f}' for x in q['scaling']['turns'])
                  for i, q in enumerate(ranks))
              + f'; the one card\'s program at {DDP_BS} rows {one[1]:.2f}, '
              f'{one[2]:.2f}  [{card}]')
        q = ranks[0]['scaling']
        print(f'[ddp graphs] {world} ranks, rank 0, one traced step: device '
              f'ms / idle share eager {q["busy"]["eager"]:.2f} / '
              f'{_share(q["idle"]["eager"])}, program '
              f'{q["busy"]["program"]:.2f} / {_share(q["idle"]["program"])};'
              f' the program\'s top device activities ' + _tops(q['top'])
              + f'; one card\'s ' + _tops(r[DDP_GRAPH_CASES[1][0]]['top'])
              + f'  [{card}]')
    return {'nms': r['nms']}


def _split_packed(sdet, frames, halves):
    """The canvas program on each of `halves` parts of the frames' host
    canvases: the detection lists the single-device detector gives a batch
    the size of one replica's share."""
    from yoloclip_tpu_torch.inference.detector import _unpack_detections
    out = []
    n = len(frames) // halves
    for h in range(halves):
        part = frames[h * n:(h + 1) * n]
        canv, meta = [], []
        for f in part:
            c, scale = sdet._host_letterbox(f)
            canv.append(c)
            meta.append([scale, f.shape[1], f.shape[0]])
        meta = torch.tensor(meta, dtype=torch.float32, device='cuda')
        packed = sdet._detect_canvases(
            torch.from_numpy(np.stack(canv)).cuda(), sdet.offline_vocabulary,
            meta[:, 0], meta[:, 1:]).cpu().numpy()
        out += [_unpack_detections(p, sdet.class_names)[0] for p in packed]
    return out


def phase_dp_serve(sim, nms, i8, vocab_path, tmp: str, card: str) -> list:
    """[dp serve]: a DetectionServer and a StreamingDetector over two
    replicas on cuda:0 against the single-device program on each replica's
    share, fp32 conf -1.0; one `serve --devices cuda:0,cuda:0 --int8`
    batch. Returns the launches of the three runs."""
    from yoloclip_tpu_torch.inference.server import DetectionServer
    from yoloclip_tpu_torch.inference.streaming import StreamingDetector
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    mesh = create_mesh(n_data=2, devices=['cuda:0', 'cuda:0'])
    sdet = _detector(vocab_path, host_preprocess='auto', conf_threshold=-1.0)
    frames = _mixed_frames(70, 8)
    _zero_counts(sim, nms)
    with DetectionServer(sdet, max_batch=BATCH, max_delay_ms=300.0,
                         mesh=mesh) as srv:
        got = [f.result(timeout=120) for f in [srv.submit(f)
                                                for f in frames]]
        st = srv.stats()
    torch.cuda.synchronize()
    srv_launches = _counts(sim, nms)
    want = _split_packed(sdet, frames, 2)
    print(f'[dp serve] DetectionServer over {mesh}, fp32 conf -1.0, 8 mixed '
          f'requests: {st["batches"]} batch of bucket {st["mean_bucket"]:g} '
          f'split 4 + 4; equal to the single-device canvas program on each '
          f'half: {got == want}; launches {srv_launches}')
    require(st['batches'] == 1 and got == want,
            '[dp serve] the server over two replicas differs')
    require(srv_launches['similarity'] >= 2 and srv_launches['nms'] >= 2,
            '[dp serve] kernels 1 and 2 did not launch on both replicas')

    single = StreamingDetector(sdet.model, sdet.offline_vocabulary, 4,
                               FRAME_SIZES[0], sdet.config)
    meshed = StreamingDetector(sdet.model, sdet.offline_vocabulary, 8,
                               FRAME_SIZES[0], sdet.config, mesh=mesh)
    f8 = np.random.RandomState(72).randint(
        0, 256, (8,) + FRAME_SIZES[0] + (3,), dtype=np.uint8)
    _zero_counts(sim, nms)
    halves = [single.step(f8[:4]), single.step(f8[4:])]
    torch.cuda.synchronize()
    per_two = _counts(sim, nms)      # two single-device steps
    _zero_counts(sim, nms)
    out = meshed.step(f8)
    torch.cuda.synchronize()
    stream_launches = _counts(sim, nms)
    same = all(torch.equal(out[k], torch.cat([h[k] for h in halves]))
               for k in out)
    print(f'[dp serve] StreamingDetector, 8 streams of 480x640 over two '
          f'replicas vs 4-stream single-device steps on each half: '
          f'identical={same}; launches {stream_launches} (two single-'
          f'device steps: {per_two})')
    require(same, '[dp serve] streaming over two replicas differs')
    require(stream_launches == per_two and per_two['nms'] == 2,
            '[dp serve] streaming: kernels 1 and 2 not on both replicas')

    # serve --devices cuda:0,cuda:0 --int8 (bf16, calibrated on PNG files)
    import argparse

    from yoloclip_tpu_torch.cli.serve import build_server, parse_args
    calib = os.path.join(tmp, 'calib')
    os.makedirs(calib, exist_ok=True)
    for i, f in enumerate(_mixed_frames(73, 4)):
        with open(os.path.join(calib, f'{i}.png'), 'wb') as fh:
            fh.write(_png(f))
    args = parse_args(['--vocab', vocab_path, '--int8', '--calib-dir', calib,
                       '--devices', 'cuda:0,cuda:0', '--conf', '-1.0'])
    require(isinstance(args, argparse.Namespace), 'serve args')
    srv, det = build_server(args)
    try:
        reqs = _mixed_frames(74, 2)
        _zero_int8(sim, nms, i8)
        got = [f.result(timeout=120) for f in [srv.submit(f) for f in reqs]]
        torch.cuda.synchronize()
        int8_launches = _int8_counts(sim, nms, i8)
        st = srv.stats()
    finally:
        srv.close()
    want = _split_packed(det, reqs, 2)
    print(f'[dp serve] serve --devices cuda:0,cuda:0 --int8 (bf16): '
          f'{st["batches"]} batch of 2 requests, one a replica; equal to '
          f'the int8 canvas program on each: {got == want}; launches '
          f'{int8_launches}')
    require(got == want, '[dp serve] int8 server over two replicas differs')
    require(int8_launches['int8_conv_bf16'] == 2 * INT8_BLOCKS,
            '[dp serve] the int8 kernel did not run on both replicas')
    del srv, det
    return [srv_launches, stream_launches, int8_launches]


def _share(x) -> str:
    return 'not measured (no device activity recorded)' if x is None \
        else f'{x:.3f}'


def phase_profile(sim, nms, bf, frames, tmp: str, card: str) -> dict:
    """[profile]: utils/profiling.py on the bf16 detect_batch at bs=32:
    trace() writes a Chrome trace that must hold kernel 1's and kernel 2's
    events; the device's idle share of 10 calls read from it; the
    program's own trace of those calls (`take`: its spans, the stages its
    graph marks, its counters), and the device's idle gaps by program
    span. Returns the launches of the traced calls."""
    from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                    idle_gaps_by_span,
                                                    memory_stats, take,
                                                    trace)
    _zero_counts(sim, nms)
    for _ in range(3):
        bf.detect_batch(frames)
    torch.cuda.synchronize()
    per_call = {k: v // 3 for k, v in _counts(sim, nms).items()}
    _zero_counts(sim, nms)
    take()
    log_dir = os.path.join(tmp, 'trace')
    with trace(log_dir) as prof:     # the program traces while it records
        with annotate('detect_batch x10'):
            for _ in range(10):
                bf.detect_batch(frames)
            torch.cuda.synchronize()
    launches = _counts(sim, nms)
    got = take()
    summary = device_summary(prof, span='detect_batch x10')
    with open(os.path.join(log_dir, 'trace.json')) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    # demangled: 'void (anonymous namespace)::similarity_wgmma<...>(...)'
    k1 = any('similarity_wgmma' in n for n in names)
    k2 = any('nms_mask' in n or 'nms_scan' in n for n in names)
    top = sorted(summary['kernels'].items(), key=lambda kv: -kv[1][0])[:8]
    size = os.path.getsize(os.path.join(log_dir, 'trace.json'))
    print(f'[profile] trace() of 10 bf16 detect_batch calls, bs={BATCH}, '
          f'640 px: Chrome trace of {size} bytes, kernel 1 events={k1}, '
          f'kernel 2 events={k2}; host span {summary["span_ms"]:.2f} ms, '
          f'device busy {summary["busy_ms"]:.2f} ms, idle share '
          f'{_share(summary["idle_share"])}; launches {launches}  [{card}]')
    for name, (ms, n) in top:
        print(f'[profile]   {ms / 10:8.3f} ms a call  {n // 10:4d}x  '
              f'{name[:100]}')
    require(k1 and k2, '[profile] the trace holds no kernel 1 or 2 events')
    require(launches == {k: 10 * v for k, v in per_call.items()}
            and launches['similarity_bf16'] > 0 and launches['nms'] > 0,
            '[profile] detect_batch launch counts')

    spans: dict = {}
    for s in got['spans']:
        spans.setdefault(s['name'], []).append(
            (s['end_ns'] - s['start_ns']) / 1e6)
    stages: dict = {}
    for sample in got['stages']:
        for stage, ms in sample['stages']:
            stages.setdefault(stage, []).append(ms)
    # the frames are on the card, so the host runs ahead of the device and
    # a replay's marks are mostly still running when the next replay reads
    # them (missed); take() reads the last one
    missed = got['counters'].get('stage_samples_missed', 0)
    require(len(spans.get('yoloclip.detect_batch', ())) == 10
            and {len(v) for v in stages.values()} == {10 - missed}
            and list(stages) == ['letterbox', 'backbone', 'neck', 'head',
                                 'postprocess'],
            f'[profile] the program traced {len(got["spans"])} spans, '
            f'stages {[(k, len(v)) for k, v in stages.items()]}, '
            f'{missed} missed')
    print('[profile] program spans, median ms of 10 calls: ' + ', '.join(
        f'{k[len("yoloclip."):]} {statistics.median(v):.3f}'
        for k, v in spans.items()) + f'  [{card}]')
    print(f'[profile] stages from the graph marks, device ms an image '
          f'(mean of {10 - missed} replays of {BATCH}): ' + ', '.join(
              f'{k} {statistics.mean(v) / BATCH:.4f}'
              for k, v in stages.items())
          + f'; counters {got["counters"]}  [{card}]')
    gaps = idle_gaps_by_span(prof, 'detect_batch x10')
    print('[profile] device idle gaps by program span, ms of 10 calls: '
          + ', '.join(f'{k} {1e3 * v:.3f}' for k, v in sorted(
              gaps.items(), key=lambda kv: -kv[1])))
    mem = memory_stats()
    print(f'[profile] memory_stats(): {len(mem)} device(s), cuda:0 peak '
          f'allocated {mem["cuda:0"]["allocated_bytes.all.peak"] / 2 ** 30:.2f}'
          f' GiB')
    return launches


# ---------------------------------------------------------------------------
# the 'model' mesh axis: class parallelism and spatial partitioning
# ---------------------------------------------------------------------------

# Class-sharded scores against the unsharded program, fp32 (TF32 off): each
# class's raw score is the same tile arithmetic in either block; the text
# after I-Pool may round apart in its per-block matmuls.
VOCAB_TP_SCORE_ATOL = 1e-6
# JAX's spatial bounds (tests/test_spatial.py): scores 1e-4, boxes 1 px.
SPATIAL_SCORE_ATOL, SPATIAL_BOX_PX = 1e-4, 1.0
SPATIAL_TIMED = 5
MULTIHOST_PROCS, MULTIHOST_MODEL, MULTIHOST_RTOL = 8, 2, 1e-5


def _k1_check(sim, h, t, K, b, nv, tag):
    """Kernel 1 against its plain version on one class block; with
    num_valid 0 the masked NEG / ||hK + b|| and id 0 (held relatively).
    Returns the score difference (relative for num_valid 0)."""
    s, i = sim.fused_projected_similarity_argmax(h, t, K, b, nv)
    ps, pi = sim.similarity_argmax_plain(h, t, K, b, nv)
    torch.cuda.synchronize()
    if nv == 0:
        err = (s / ps - 1).abs().max().item()
        ok = err <= SIM_ATOL and bool((i == 0).all()) and bool((pi == 0).all())
        print(f'[vocab tp] kernel 1 {tag} num_valid=0: NEG/norm relative '
              f'diff {err:.3e} (tol {SIM_ATOL:g}); all ids 0: {ok}')
        require(ok, f'kernel 1 on a block with no valid class ({tag})')
        return err
    tp, cb = sim._fold_text(t, K, b, h.dtype)
    raw = torch.matmul(h.float(), tp.float().transpose(1, 2)) + cb[:, None]
    norm = (torch.matmul(h.float(), K.to(h.dtype).float()) + b).norm(
        dim=-1).clamp_min(1e-12)
    tie = _near_ties(raw, norm)
    del raw
    err = (s - ps).abs().max().item()
    bad = ((i != pi) & ~tie).sum().item()
    print(f'[vocab tp] kernel 1 {tag}: max|score-plain|={err:.3e} (tol '
          f'{SIM_ATOL:g}) id mismatches outside near-ties={bad}')
    require(err <= SIM_ATOL and bad == 0, f'kernel 1 on a block ({tag})')
    return err


def _k3_check(sim, obj, t, nv, tag):
    """Kernel 3 (normalize_obj) against its plain version on one class
    block; with num_valid 0 the masked NEG / ||obj|| and id 0. Returns the
    score difference (relative for num_valid 0)."""
    s, i = sim.fused_similarity_argmax(obj, t, nv, normalize_obj=True)
    ps, pi = sim.similarity_argmax_reference_plain(obj, t, nv, True)
    torch.cuda.synchronize()
    if nv == 0:
        live = torch.isfinite(ps)   # a zero row: NEG / 1e-12 overflows
        err = (s[live] / ps[live] - 1).abs().max().item()
        ok = (err <= SIM_ATOL and bool((i == 0).all())
              and bool((s[~live] == ps[~live]).all()))
        print(f'[vocab tp] kernel 3 {tag} num_valid=0: NEG/norm relative '
              f'diff {err:.3e} (tol {SIM_ATOL:g}); all ids 0: {ok}')
        require(ok, f'kernel 3 on a block with no valid class ({tag})')
        return err
    tie = _near_ties(torch.matmul(obj.float(), t.transpose(1, 2)),
                     obj.float().norm(dim=-1).clamp_min(1e-12))
    err = (s - ps).abs().max().item()
    bad = ((i != pi) & ~tie).sum().item()
    print(f'[vocab tp] kernel 3 {tag}: max|score-plain|={err:.3e} (tol '
          f'{SIM_ATOL:g}) id mismatches outside near-ties={bad}')
    require(err <= SIM_ATOL and bad == 0, f'kernel 3 on a block ({tag})')
    return err


def _on_shards(n, fn):
    """fn(rank, member) on n threads of one in-process group (cuda:0)."""
    from yoloclip_tpu_torch.parallel import collectives as col
    group, workers = col.LocalGroup(n), col.ShardThreads(n)
    try:
        return workers.run([lambda r=r: fn(r, group.member(r))
                            for r in range(n)], [group])
    finally:
        workers.close()


def _batched_lists(out, names):
    """A batched NMS dict -> one detection list an image."""
    from yoloclip_tpu_torch.inference.detector import (_pack_detections,
                                                       _unpack_detections)
    packed = _pack_detections(out).cpu().numpy()
    return [_unpack_detections(p, names)[0] for p in packed]


class _Int8Recorder:
    """Wraps the int8 conv the ConvBlocks call: every launch goes on (and
    is counted by the wrapper); the input of the first launch of each
    (block shape, input rows) is kept, so that the kernel's accumulators
    can be held against the plain version's on it afterwards."""

    def __init__(self):
        from yoloclip_tpu_torch.models import layers
        self.layers, self.real = layers, layers.int8_conv
        self.kept, self.lock = {}, threading.Lock()

    def __enter__(self):
        def rec(x, wq, wscale, qbias, act_scale, stride, epilogue=True):
            key = (tuple(wq.shape), stride, x.shape[2], str(x.dtype))
            with self.lock:
                if key not in self.kept:
                    self.kept[key] = (x.clone(), wq, wscale, qbias,
                                      act_scale, stride)
            return self.real(x, wq, wscale, qbias, act_scale, stride,
                             epilogue)
        self.layers.int8_conv = rec
        return self

    def __exit__(self, *exc):
        self.layers.int8_conv = self.real

    def check(self, i8, tag) -> int:
        """Kernel accumulators == plain on every kept input; returns how
        many inputs were checked."""
        rows = sorted({k[2] for k in self.kept})
        for key, (x, wq, ws, qb, a, s) in self.kept.items():
            got = i8.int8_conv(x, wq, ws, qb, a, s, epilogue=False)
            want = i8.int8_conv_plain(x, wq, ws, qb, a, s, epilogue=False)
            require(torch.equal(got, want),
                    f'{tag}: int8 accumulators differ from plain at {key}')
        print(f'{tag} int8_conv accumulators equal to the plain version on '
              f'{len(self.kept)} recorded inputs (each block shape x input '
              f'rows; rows seen {rows})')
        n = len(self.kept)
        self.kept.clear()
        return n


def _int8_blocks(model):
    from yoloclip_tpu_torch.models.layers import ConvBlock
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, ConvBlock) and m.mode == 'int8']


def _shard_key():
    """(batch shard, height shard) of the calling thread: the split
    runners name their threads yoloclip-shard-{batch * nh + height}."""
    from yoloclip_tpu_torch.parallel import spatial
    name = threading.current_thread().name
    r = (int(name.rsplit('-', 1)[1]) if name.startswith('yoloclip-shard-')
         else 0)
    sh = spatial.current()
    nh = len(sh.blocks) if sh is not None else 1
    return r // nh, r % nh


class _Int8Inputs:
    """Forward pre-hooks on a model's int8 ConvBlocks. record(): keep each
    block's input per calling shard ((batch, height) shard: the rows it
    holds, before any halo); whole(): a block's whole-frame input from
    them (height shards in row order, then batch shards); force(inputs):
    every block's input replaced by inputs[name]."""

    def __init__(self, model):
        self.blocks = _int8_blocks(model)
        self.kept, self.lock, self.handles = {}, threading.Lock(), []

    def record(self):
        def hook(name):
            def pre(mod, args):
                with self.lock:
                    self.kept.setdefault(name, {})[_shard_key()] = \
                        args[0].detach().clone()
            return pre
        self.handles = [m.register_forward_pre_hook(hook(n))
                        for n, m in self.blocks]
        return self

    def force(self, inputs):
        self.handles = [m.register_forward_pre_hook(
            lambda mod, args, n=n: (inputs[n],)) for n, m in self.blocks]
        return self

    def whole(self, name, height: bool = True):
        """height=False: the shards are class shards of one batch, every
        one holding the same rows: shard 0's."""
        parts = self.kept[name]
        if not height:
            return parts[(0, 0)]
        nb = 1 + max(b for b, _ in parts)
        nh = 1 + max(h for _, h in parts)
        return torch.cat([torch.cat([parts[(b, h)] for h in range(nh)], 2)
                          for b in range(nb)], 0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []


def _int8_forced(tag, model, split_fwd, canv, text, height, card):
    """The split int8 program against the unsplit one on the same
    canvases: free-running (the int8 inputs' rounding flips counted), and
    with every int8 block's input forced to the split run's (the halo
    rows and the per-block products may round an int8 input the other
    way; forced, only the float ops after the blocks differ). Returns the
    forced pre-NMS score difference."""
    from yoloclip_tpu_torch.ops.kernels.int8_conv import quantize_plain
    rec = _Int8Inputs(model)
    with torch.inference_mode():
        with rec.record():
            split = split_fwd(canv, text, fused_scores=True)
        forced_in = {n: rec.whole(n, height) for n, _ in rec.blocks}
        free_rec = _Int8Inputs(model)
        with free_rec.record():
            free = model(canv, text, fused_scores=True)
        with _Int8Inputs(model).force(forced_in):
            forced = model(canv, text, fused_scores=True)
            unf = model(canv, text)
    flips = total = 0
    for n, m in rec.blocks:
        a = quantize_plain(forced_in[n], m.act_scale)
        b = quantize_plain(free_rec.kept[n][(0, 0)], m.act_scale)
        flips += int((a != b).sum())
        total += a.numel()
    top2 = unf['similarity'].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP
    err = (split['scores'] - forced['scores']).abs().max().item()
    bad = ((split['class_ids'] != forced['class_ids']) & ~tie).sum().item()
    free_err = (split['scores'] - free['scores']).abs().max().item()
    print(f'{tag} int8 split vs unsplit on the same canvases: free-running '
          f'pre-NMS scores max|diff| {free_err:.3e} ({flips} of {total} '
          f'int8 inputs ({flips / max(total, 1):.2e}) round the other way); '
          f'with every int8 block\'s input forced to the split run\'s: '
          f'max|diff| {err:.3e}, id mismatches outside near-ties {bad}  '
          f'[{card}]')
    require(bad == 0, f'{tag} int8: forced ids differ')
    return err


def _int8_counts_all(sim, nms, i8) -> dict:
    out = _int8_counts(sim, nms, i8)
    out['similarity_unprojected'] = (sim.unprojected_launches
                                     - sim.unprojected_launches_bf16)
    return out


def _check_split(tag, got, want, got_scores, want_scores, names, topk,
                 score_atol):
    """Two batched NMS dicts of one program, split and unsplit: the
    pre-NMS scores' largest difference, then each image's detections
    through `_check_detections`. Returns (compared, total)."""
    delta = (got_scores - want_scores).abs().max().item()
    g, w = _batched_lists(got, names), _batched_lists(want, names)
    n = t = 0
    for i in range(len(w)):
        a, b = _check_detections(f'{tag} image {i}', g[i], w[i],
                                 want_scores[i].float().cpu(), delta, topk,
                                 score_atol)
        n, t = n + a, t + b
    return delta, n, t


def phase_vocab_tp(sim, nms, i8, lvis_vocab, frames, tmp, card):
    """[vocab tp]: detect_batch at bs=32 with the 1203-class vocabulary
    over an in-process 1x2 mesh (cuda:0 twice), each class block's kernel 1
    on a thread of its own, merged; against the unsharded program. Then
    each shard's kernel-1 launch, a block with num_valid 0, and kernel 3's
    sharded scoring (C = 1203) against the plain versions; the int8 batch
    over the same mesh against the single-device int8 batch. Returns the
    launches of the class-sharded runs."""
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch_for
    from yoloclip_tpu_torch.parallel import collectives as col
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    from yoloclip_tpu_torch.parallel.train_step import make_sharded_inference
    path = os.path.join(tmp, 'lvis_vocab.json')
    rows = lvis_vocab.cpu().numpy()
    with open(path, 'w') as f:
        json.dump({n: r.tolist() for n, r in zip(LVIS_NAMES, rows)}, f)
    det = _detector(path, conf_threshold=-1.0)
    mesh = create_mesh(n_data=1, n_model=2, devices=['cuda:0', 'cuda:0'])
    run = make_sharded_inference(det.model, mesh)
    sharded = lambda x, t, **kw: run(x, t, **kw)[0]   # noqa: E731
    text = det.offline_vocabulary
    with torch.inference_mode():
        canv, _ = letterbox_batch_for(det.config.model)(frames,
                                                        det.image_size)
        one = det.model(canv, text, fused_scores=True)
        unf = det.model(canv, text)
        two = sharded(canv, text, fused_scores=True)
    want = det.detect_batch(frames)
    det._batch_model = sharded
    torch.cuda.synchronize()
    _zero_int8(sim, nms, i8)
    t0 = time.perf_counter()
    got = det.detect_batch(frames)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _int8_counts_all(sim, nms, i8)
    det._batch_model = None
    t0 = time.perf_counter()
    det.detect_batch(frames)
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) * 1e3
    top2 = unf['similarity'].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP
    err = (two['scores'] - one['scores']).abs().max().item()
    bad = ((two['class_ids'] != one['class_ids']) & ~tie).sum().item()
    delta, n, tot = _check_split('[vocab tp] fp32', got, want, two['scores'],
                                 one['scores'], det.class_names,
                                 det.config.nms_topk, VOCAB_TP_SCORE_ATOL)
    print(f'[vocab tp] fp32 detect_batch bs={BATCH} C={LVIS_C} over '
          f'{mesh}: launches {launches}; scores vs unsharded max|diff| '
          f'{err:.3e} (tol {VOCAB_TP_SCORE_ATOL:g}), id mismatches outside '
          f'near-ties {bad} (near-tie anchors exempt {int(tie.sum())}); '
          f'detections compared {n} of {tot}; call {ms:.1f} ms vs '
          f'{ms1:.1f} ms unsharded (one card: the merge\'s cost, not '
          f'scaling)  [{card}]')
    require(err <= VOCAB_TP_SCORE_ATOL and bad == 0,
            '[vocab tp] class-sharded scores differ')
    require(launches['similarity'] == 2 * len(LEVELS) and
            launches['nms'] == 1,
            '[vocab tp] kernel 1 did not run once a shard and level')
    del unf, one, two

    # each shard's kernel-1 launch at the main path's shapes, a block with
    # no valid class, and the merge through two threads
    g = torch.Generator(device='cuda').manual_seed(8)
    h, t, K, b = _sim_inputs(g, LEVELS[0], LVIS_C, torch.float32)
    blocks = [col.class_block(LVIS_C, 2, m) for m in range(2)]
    k1_err = 0.0
    for m, (off, size) in enumerate(blocks):
        k1_err = max(k1_err, _k1_check(
            sim, h, t[:, off:off + size], K, b, None,
            f'shard {m} (C={size}, B={BATCH}, A={LEVELS[0]})'))
    _k1_check(sim, h, t[:, blocks[1][0]:], K, b, 0, 'shard 1 forced')
    merged = _on_shards(2, lambda r, grp: sim.sharded_projected_similarity_argmax(
        h, t[:, blocks[r][0]:sum(blocks[r])], K, b,
        col.ClassShard(*blocks[r], LVIS_C, grp), num_valid=1000))
    ps, pi = sim.similarity_argmax_plain(h, t, K, b, 1000)
    for s, i in merged:
        # rows 7 and 700 copy row 3 (700 in shard 1): ties go to class 3
        require((s - ps).abs().max().item() <= SIM_ATOL
                and bool((i < 1000).all())
                and not bool(((i == 7) | (i == 700)).any()),
                '[vocab tp] merged kernel 1 over shards (num_valid 1000)')
    del h, t

    # kernel 3 over the class shards of the unfolded graph (C = 1203)
    obj, t = _obj_inputs(g, ANCHORS, LVIS_C, torch.float32, True)
    k3_err = 0.0
    for m, (off, size) in enumerate(blocks):
        k3_err = max(k3_err, _k3_check(sim, obj, t[:, off:off + size], None,
                                       f'shard {m} (C={size})'))
    _k3_check(sim, obj, t[:, blocks[1][0]:], 0, 'shard 1 forced')
    _zero_counts(sim, nms)
    merged = _on_shards(2, lambda r, grp: sim.sharded_similarity_argmax(
        obj, t[:, blocks[r][0]:sum(blocks[r])],
        col.ClassShard(*blocks[r], LVIS_C, grp), normalize_obj=True))
    torch.cuda.synchronize()
    k3_launches = sim.unprojected_launches
    ps, pi = sim.similarity_argmax_reference_plain(obj, t,
                                                   normalize_obj=True)
    tie = _near_ties(torch.matmul(obj.float(), t.transpose(1, 2)),
                     obj.norm(dim=-1).clamp_min(1e-12))
    for s, i in merged:
        require((s - ps).abs().max().item() <= SIM_ATOL
                and ((i != pi) & ~tie).sum().item() == 0
                and not bool(((i == 7) | (i == 700)).any()),
                '[vocab tp] merged kernel 3 over shards')
    print(f'[vocab tp] kernel 3 over 2 class shards (C={LVIS_C}, A='
          f'{ANCHORS}): {k3_launches} launches, merged vs plain within '
          f'{SIM_ATOL:g}; a block with num_valid 0 gives NEG and id 0')
    launches['similarity_unprojected'] += k3_launches
    del obj, t

    # the int8 batch over the same mesh
    det.quantize_int8(frames[:INT8_CALIB])
    run = make_sharded_inference(det.model, mesh)
    det._batch_model = lambda x, tt, **kw: run(x, tt, **kw)[0]
    torch.cuda.synchronize()
    _zero_int8(sim, nms, i8)
    with _Int8Recorder() as rec:
        det.detect_batch(frames)
        torch.cuda.synchronize()
        l8 = _int8_counts_all(sim, nms, i8)
    rec.check(i8, '[vocab tp] int8 over the 1x2 mesh:')
    print(f'[vocab tp] int8 fp32 detect_batch over the mesh: launches {l8}')
    err = _int8_forced('[vocab tp]', det.model, det._batch_model, canv,
                       text, False, card)
    require(err <= VOCAB_TP_SCORE_ATOL, '[vocab tp] int8 forced scores')
    require(l8['int8_conv'] == 2 * INT8_BLOCKS
            and l8['similarity'] == 2 * len(LEVELS),
            '[vocab tp] int8: a kernel did not run on both shards')
    for k, v in l8.items():
        launches[k] = launches.get(k, 0) + v
    del det, run
    return launches, k1_err, k3_err


def _timed_detect(det, frame):
    """Median ms of det.detect(frame) over SPATIAL_TIMED calls (after one
    warm-up) and the last call's detections."""
    det.detect(frame)
    times = []
    for _ in range(SPATIAL_TIMED):
        t0 = time.perf_counter()
        out = det.detect(frame)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def _canvas_scores(det, frame, split):
    """Pre-NMS scores of the canvas program on one frame, unsplit or
    through the detector's split."""
    canvas, _ = det._host_letterbox(frame)
    x = torch.from_numpy(canvas)[None].cuda().float() / 255.0
    with torch.inference_mode():
        fwd = det._canvas_model if split else det.model
        return fwd(x, det.offline_vocabulary, fused_scores=True)['scores']


def phase_spatial(sim, nms, i8, vocab_path, frames, card):
    """[spatial]: one 640-px frame through detect() split 2 and 4 ways
    over in-process meshes of cuda:0, and detect_batch at bs=32 on a 2x2
    grid (batch over 'data' x height over 'model'), fp32 and int8, against
    the unsplit programs (JAX's spatial bounds); the 1-, 2- and 4-way
    latencies. Returns the launches of the split runs."""
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch_for
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
    det = _detector(vocab_path, host_preprocess='auto', conf_threshold=-1.0)
    frame = frames[0].cpu().numpy()
    topk = det.config.nms_topk
    ms1, base = _timed_detect(det, frame)
    s1 = _canvas_scores(det, frame, False)
    launches, lat = {}, {1: ms1}
    for ways, shape in ((2, (1, 2)), (4, (2, 2))):
        mesh = create_mesh(*shape, devices=['cuda:0'] * ways)
        spatialize_detector(det, mesh)
        torch.cuda.synchronize()
        _zero_counts(sim, nms)
        got = det.detect(frame)
        torch.cuda.synchronize()
        counted = _counts(sim, nms)
        lat[ways], _ = _timed_detect(det, frame)
        delta = (_canvas_scores(det, frame, True) - s1).abs().max().item()
        n, tot = _check_detections(f'[spatial] {ways}-way detect', got, base,
                                   s1[0].cpu(), delta, topk,
                                   SPATIAL_SCORE_ATOL)
        print(f'[spatial] detect() split {ways} ways over {mesh}: launches '
              f'{counted}; pre-NMS scores max|diff| {delta:.3e}; '
              f'detections compared {n} of {tot} (scores {SPATIAL_SCORE_ATOL:g}'
              f', boxes {SPATIAL_BOX_PX:g} px)')
        require(counted['similarity'] == ways * len(LEVELS)
                and counted['nms'] == 1,
                f'[spatial] {ways}-way: kernels 1 and 2 did not launch')
        require(delta <= SPATIAL_SCORE_ATOL, f'[spatial] {ways}-way scores')
        for k, v in counted.items():
            launches[k] = launches.get(k, 0) + v
    print(f'[spatial] detect() latency, one 640-px frame, median of '
          f'{SPATIAL_TIMED}: 1-way {lat[1]:.2f} ms, 2-way {lat[2]:.2f} ms, '
          f'4-way {lat[4]:.2f} ms (every shard on the one card: correctness '
          f'and the halo exchange\'s cost, not scaling)  [{card}]')

    mesh = create_mesh(2, 2, devices=['cuda:0'] * 4)
    for tag in ('fp32', 'int8'):
        if tag == 'int8':
            det.quantize_int8(frames[:INT8_CALIB])
        det._batch_model = None
        with torch.inference_mode():
            canv, _ = letterbox_batch_for(det.config.model)(frames,
                                                            det.image_size)
            s_one = det.model(canv, det.offline_vocabulary,
                              fused_scores=True)['scores']
        want = det.detect_batch(frames)
        t0 = time.perf_counter()
        det.detect_batch(frames)
        torch.cuda.synchronize()
        ms_one = (time.perf_counter() - t0) * 1e3
        spatialize_detector(det, mesh, batch_axis='data',
                            height_axis='model')
        torch.cuda.synchronize()
        _zero_int8(sim, nms, i8)
        with _Int8Recorder() as rec:
            t0 = time.perf_counter()
            got = det.detect_batch(frames)
            torch.cuda.synchronize()
            ms_split = (time.perf_counter() - t0) * 1e3
            counted = _int8_counts_all(sim, nms, i8)
        if tag == 'int8':
            rec.check(i8, '[spatial] int8 2x2 (halo-extended rows):')
            require(counted['int8_conv'] == 4 * INT8_BLOCKS,
                    '[spatial] int8: the kernel did not run on every shard')
            print(f'[spatial] int8 fp32 detect_batch bs={BATCH} over {mesh} '
                  f'(batch over data x height over model): launches '
                  f'{counted}; {ms_split:.1f} ms vs {ms_one:.1f} ms unsplit'
                  f'  [{card}]')
            err = _int8_forced('[spatial] 2x2', det.model, det._batch_model,
                               canv, det.offline_vocabulary, True, card)
            require(err <= SPATIAL_SCORE_ATOL, '[spatial] int8 forced scores')
        else:
            with torch.inference_mode():
                s_two = det._batch_model(canv, det.offline_vocabulary,
                                         fused_scores=True)['scores']
            delta, n, tot = _check_split(
                '[spatial] fp32 2x2', got, want, s_two, s_one,
                det.class_names, topk, SPATIAL_SCORE_ATOL)
            print(f'[spatial] fp32 detect_batch bs={BATCH} over {mesh} '
                  f'(batch over data x height over model): launches '
                  f'{counted}; pre-NMS scores max|diff| {delta:.3e}; '
                  f'detections compared {n} of {tot}; {ms_split:.1f} ms vs '
                  f'{ms_one:.1f} ms unsplit  [{card}]')
            require(delta <= SPATIAL_SCORE_ATOL, '[spatial] 2x2 scores')
        require(counted['similarity'] == 4 * len(LEVELS)
                and counted['nms'] == 1,
                f'[spatial] {tag} 2x2: kernels 1 and 2 did not launch')
        for k, v in counted.items():
            launches[k] = launches.get(k, 0) + v
    del det
    return launches


def _tp_rank(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    """One rank of [tp train] on cuda:0 (gloo): a compat fp32 step at
    DDP_BS over the 1x2 grid, its class block of the text; writes
    out_dir/tp{rank}.pt."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from yoloclip_tpu_torch.parallel import multihost
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    from yoloclip_tpu_torch.parallel.train_step import (
        make_sharded_train_step, place_batch, place_text)
    from yoloclip_tpu_torch.train import train_state as ts
    multihost.initialize(f'file://{rendezvous}', world, rank,
                         device='cuda:0', backend='gloo',
                         timeout_s=DDP_TIMEOUT_S)
    mesh = create_mesh(n_data=1, n_model=world)
    arrays, text, _ = _ddp_batch()
    cfg = _train_cfg(assigner='compat', dtype='float32', batch_size=DDP_BS)
    state = ts.create_train_state(_seeded_model(cfg), cfg, 'cuda:0')
    ts.set_learning_rate(state, cfg.learning_rate)
    step = make_sharded_train_step(cfg, mesh, eager=True)(state)   # gloo
    local = place_batch(arrays, mesh)
    t = place_text(text, mesh)
    parts = {k: float(v) for k, v in step(state, local, t).items()}
    res = {'parts': parts, 'block': tuple(t.shape), 'mesh': repr(mesh),
           'identical': _params_equal_over_ranks(state.model, None)}
    if rank == 0:
        res['grads'] = {k: p.grad.detach().to('cpu', copy=True)
                        for k, p in state.model.named_parameters()}
        res['state'] = {k: v.detach().to('cpu', copy=True) for k, v in
                        state.model.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DDP_TIMED):
        step(state, local, t)
    torch.cuda.synchronize()
    res['ms'] = (time.perf_counter() - t0) / DDP_TIMED * 1e3
    torch.save(res, os.path.join(out_dir, f'tp{rank}.pt'))
    multihost.shutdown()


def phase_tp_train(tmp: str, card: str) -> None:
    """[tp train]: two gloo ranks on cuda:0 as a 1x2 (data x model) grid
    take one compat fp32 class-sharded step at 640 px, bs=16, held against
    the 1-process step with [ddp]'s bounds."""
    import torch.multiprocessing as mp
    out_dir = os.path.join(tmp, 'tp')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_tp_rank, args=(2, os.path.join(out_dir, 'rdv'),
                                             out_dir),
                             nprocs=2, join=False, start_method='spawn')
    deadline = time.perf_counter() + DDP_TIMEOUT_S + 120
    try:
        while not ctx.join(timeout=5):
            require(time.perf_counter() < deadline,
                    '[tp train] ranks did not finish in time')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    r0, r1 = [torch.load(os.path.join(out_dir, f'tp{r}.pt'),
                         weights_only=False) for r in range(2)]
    print(f'[tp train] two gloo ranks on cuda:0 ({r0["mesh"]}), text blocks '
          f'{r0["block"]} / {r1["block"]}, ran in '
          f'{time.perf_counter() - t0:.1f} s with their start-up')
    require(r0['parts'] == r1['parts'], '[tp train] the ranks report other '
            'losses')
    r0['identical'] &= r1['identical']
    _compare_step('compat fp32', 'compat', 'float32', r0,
                  _single_card_step('compat fp32', 'compat', 'float32'),
                  card, label='[tp train] class-sharded 1x2,')


def phase_multihost(tmp: str, card: str) -> None:
    """[multihost 4x2]: the port's self-test in MULTIHOST_PROCS processes
    on the one card (gloo) as a 4x2 grid, classes split 2-way, each
    process's loss against the self-test in one process."""
    rdv = os.path.join(tmp, 'mh_rdv')
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    base = [sys.executable, '-m', 'yoloclip_tpu_torch.parallel.multihost',
            '--selftest', '--device', 'cuda']
    cmds = [base + ['--num-processes', str(MULTIHOST_PROCS), '--process-id',
                    str(i), '--model', str(MULTIHOST_MODEL), '--coordinator',
                    f'file://{rdv}'] for i in range(MULTIHOST_PROCS)]
    cmds.append(base)   # one process: the reference
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              cwd=env['PYTHONPATH']) for c in cmds]
    try:
        logs = [p.communicate(timeout=DDP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    secs = time.perf_counter() - t0
    losses = []
    for p, log in zip(procs, logs):
        line = [x for x in log.splitlines()
                if x.startswith('MULTIHOST_SELFTEST')]
        require(p.returncode == 0 and line,
                f'[multihost] a process failed:\n{log[-3000:]}')
        losses.append(float(line[-1].split('loss=')[1]))
    ref = losses.pop()
    worst = max(abs(v - ref) / abs(ref) for v in losses)
    print(f'[multihost 4x2] self-test: {MULTIHOST_PROCS} processes on cuda:0 '
          f'(gloo) as a {MULTIHOST_PROCS // MULTIHOST_MODEL}x'
          f'{MULTIHOST_MODEL} grid, losses {sorted(set(losses))} against '
          f'{ref} in one process (max rel {worst:.2e}, tol '
          f'{MULTIHOST_RTOL:g}); {secs:.1f} s with start-up  [{card}]')
    require(worst <= MULTIHOST_RTOL, '[multihost] a rank\'s loss differs')


# ---------------------------------------------------------------------------
# [split ranks]: the class-sharded forward and the spatial split with one
# process a cell: two gloo ranks on cuda:0 (the eager route; the program
# route must raise), and with two cards or more one NCCL rank a card (the
# programs: CUDA graphs holding NCCL's exchanges, against the eager route
# and the single-card programs).
# ---------------------------------------------------------------------------

SPLIT_CALLS = 10         # detect_batch calls a reading (median), bs=32
SPLIT_TIMEOUT_S = 240    # a [split ranks] rank's whole run


def _since(before: dict, after: dict) -> dict:
    """The launches between two readings of the counters."""
    return {k: after[k] - before[k] for k in after}


def _rank_split_tp(det, mesh, frames, dev, nccl) -> dict:
    """This rank's class-sharded LVIS detect_batch: the program route (or
    its refusal over gloo) and the eager route, each a first call (the
    capture), a counted call, pre-NMS scores and img/s."""
    from yoloclip_tpu_torch.inference import program
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch_for
    from yoloclip_tpu_torch.parallel.train_step import (
        make_sharded_inference, sharded_programs)
    text = det.offline_vocabulary
    with torch.inference_mode():
        canv, _ = letterbox_batch_for(det.config.model)(frames,
                                                        det.image_size)
    cache = sharded_programs(mesh)
    out, runs = {'refused': None}, {}
    try:
        runs['program'] = make_sharded_inference(det.model, mesh,
                                                 programs=cache)
    except RuntimeError as e:
        out['refused'] = str(e)
    runs['eager'] = make_sharded_inference(det.model, mesh, eager=True)
    for name, run in runs.items():
        det._batch_model = lambda x, t, run=run, **kw: run(x, t, **kw)[0]
        det.detect_batch(frames)            # the program's capture
        torch.cuda.synchronize()
        before = _counts(sim, nms)
        got = det.detect_batch(frames)
        torch.cuda.synchronize()
        launches = _since(before, _counts(sim, nms))
        with torch.inference_mode():
            fwd = run(canv, text, fused_scores=True)[0]
        out[name] = {'dets': {k: v.cpu() for k, v in got.items()},
                     'scores': fwd['scores'].cpu(),
                     'ids': fwd['class_ids'].cpu(), 'launches': launches,
                     'img_s': _img_per_s(det, frames, SPLIT_CALLS)}
    det._batch_model = None
    progs = cache.programs()
    out['capture_s'] = [p.capture_s for p in progs]
    out['pool'] = program.pool_bytes(dev) / 2 ** 30 if nccl else 0.0
    return out


def _rank_split_detect(det, mesh, frame, nccl, trace_dir) -> dict:
    """This rank's 640-px detect() split over the model axis: the program
    route (or its refusal over gloo) and the eager route, each a counted
    call after the first, pre-NMS scores (eager), the median ms, and one
    traced call of each route (device busy and span ms, idle share, NCCL's
    kernels' ms)."""
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim
    from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
    from yoloclip_tpu_torch.utils.profiling import (annotate, device_summary,
                                                    trace)
    out = {'refused': None}
    try:
        spatialize_detector(det, mesh)
        routes = (('program', True), ('eager', False))
    except RuntimeError as e:
        out['refused'] = str(e)
        spatialize_detector(det, mesh, eager=True)
        routes = (('eager', False),)
    for name, programs in routes:
        det._split_programs = programs
        det.detect(frame)                   # the program's capture
        torch.cuda.synchronize()
        before = _counts(sim, nms)
        got = det.detect(frame)
        torch.cuda.synchronize()
        launches = _since(before, _counts(sim, nms))
        ms, _ = _timed_detect(det, frame)
        out[name] = {'dets': got, 'launches': launches, 'ms': ms}
    # one card a rank only: two processes would trace one card together
    with trace(trace_dir) if nccl else contextlib.nullcontext() as prof:
        for name, programs in routes if nccl else ():
            det._split_programs = programs
            with annotate(name):
                det.detect(frame)
                torch.cuda.synchronize()
    for name, _ in routes if nccl else ():
        summ = device_summary(prof, span=name)
        out[name]['trace'] = (summ['busy_ms'], summ['span_ms'],
                              summ['idle_share'], sum(
                                  ms for k, (ms, _) in summ['kernels'].items()
                                  if 'nccl' in k.lower()))
    out['scores'] = _canvas_scores(det, frame, True).cpu()
    out['capture_s'] = [p.capture_s for p in det.programs.programs()
                        if p.name == 'canvas']
    return out


def _rank_split_batch(det, mesh, frames) -> dict:
    """This rank's detect_batch at bs=32 over a 2x2 grid, batch over data
    x height over model: program and eager route (every rank returns the
    whole batch's detections), pre-NMS scores (eager), img/s."""
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch_for
    from yoloclip_tpu_torch.parallel.spatial import spatialize_detector
    spatialize_detector(det, mesh, batch_axis='data', height_axis='model')
    out = {}
    for name, programs in (('program', True), ('eager', False)):
        det._split_programs = programs
        det.detect_batch(frames)
        torch.cuda.synchronize()
        before = _counts(sim, nms)
        got = det.detect_batch(frames)
        torch.cuda.synchronize()
        out[name] = {'dets': {k: v.cpu() for k, v in got.items()},
                     'launches': _since(before, _counts(sim, nms)),
                     'img_s': _img_per_s(det, frames, SPLIT_CALLS)}
    with torch.inference_mode():
        canv, _ = letterbox_batch_for(det.config.model)(frames,
                                                        det.image_size)
        out['scores'] = det._batch_model(canv, det.offline_vocabulary,
                                         fused_scores=True)['scores'].cpu()
    return out


def _split_rank(rank: int, world: int, out_dir: str, backend: str) -> dict:
    """One rank of [split ranks] (`phase_split_ranks`) over a 1 x world
    grid (gloo on cuda:0, or NCCL on cuda:{rank}): the class-sharded
    LVIS-1203 detect_batch, the 640-px detect() split `world` ways, and on
    four ranks the 2x2 detect_batch (batch over data x height over
    model). Returns its readings and the launches of the whole rank."""
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim
    from yoloclip_tpu_torch.parallel.mesh import create_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = backend == 'nccl'
    dev = torch.device('cuda', rank if nccl else 0)
    mesh = create_mesh(n_data=1, n_model=world)
    frames = _smoke_frames(dev)
    _zero_counts(sim, nms)
    out = {'mesh': repr(mesh)}
    t0 = time.perf_counter()

    def done(part, det):
        # the detector's programs hold their bodies, which hold the
        # detector: free the graphs (and their NCCL work) before going on
        det.programs.clear()
        gc.collect()
        torch.cuda.synchronize()
        print(f'[split ranks] {backend} rank {rank}/{world}: {part} done '
              f'at {time.perf_counter() - t0:.1f} s', flush=True)

    det = _detector(os.path.join(out_dir, 'lvis.json'), device=dev,
                    conf_threshold=-1.0)
    out['tp'] = _rank_split_tp(det, mesh, frames, dev, nccl)
    done('class-sharded detect_batch', det)
    det = _detector(os.path.join(out_dir, 'coco.json'), device=dev,
                    host_preprocess='auto', conf_threshold=-1.0)
    out['detect'] = _rank_split_detect(
        det, mesh, frames[0].cpu().numpy(), nccl,
        os.path.join(out_dir, f'trace_{backend}{world}_{rank}'))
    done('split detect()', det)
    if nccl and world == 4:
        det = _detector(os.path.join(out_dir, 'coco.json'), device=dev,
                        conf_threshold=-1.0)
        out['batch'] = _rank_split_batch(det, create_mesh(2, 2), frames)
        done('2x2 detect_batch', det)
    del det
    gc.collect()
    out['launches'] = _counts(sim, nms)
    return out


def _split_refs(sim, nms, vocab_path, lvis_path, frames, card) -> dict:
    """The single-card references of [split ranks] on cuda:0: the LVIS
    unsharded forward (scores, near-tie mask), its detect_batch program
    and img/s; the COCO canvas detect() program (detections, pre-NMS
    scores, ms program and eager); the COCO detect_batch program at bs=32
    (pre-NMS scores, img/s)."""
    from yoloclip_tpu_torch.ops.preprocess import letterbox_batch_for
    ref = {}
    det = _detector(lvis_path, conf_threshold=-1.0)
    text = det.offline_vocabulary
    with torch.inference_mode():
        canv, _ = letterbox_batch_for(det.config.model)(frames,
                                                        det.image_size)
        one = det.model(canv, text, fused_scores=True)
        top2 = det.model(canv, text)['similarity'].topk(2, dim=-1).values
    ref['tp'] = {'scores': one['scores'], 'ids': one['class_ids'],
                 'tie': (top2[..., 0] - top2[..., 1]) < XDEV_TIE_GAP,
                 'dets': det.detect_batch(frames), 'names': det.class_names,
                 'topk': det.config.nms_topk,
                 'img_s': _img_per_s(det, frames, SPLIT_CALLS)}
    del det, one, top2
    det = _detector(vocab_path, host_preprocess='auto', conf_threshold=-1.0)
    frame = frames[0].cpu().numpy()
    ms, base = _timed_detect(det, frame)
    det._canvas_model = det.model      # the canvas body, eagerly
    ms_eager, _ = _timed_detect(det, frame)
    det._canvas_model = None
    ref['detect'] = {'dets': base, 'scores': _canvas_scores(
        det, frame, False)[0].cpu(), 'ms': ms, 'ms_eager': ms_eager}
    with torch.inference_mode():
        ref['batch'] = {'scores': det.model(canv, det.offline_vocabulary,
                                            fused_scores=True)['scores'],
                        'dets': det.detect_batch(frames),
                        'img_s': _img_per_s(det, frames, SPLIT_CALLS),
                        'names': det.class_names}
    del det
    print(f'[split ranks] single-card programs on cuda:0: LVIS-1203 '
          f'detect_batch bs={BATCH} {ref["tp"]["img_s"]:.1f} img/s; '
          f'640-px detect() {ms:.2f} ms (its canvas body eagerly '
          f'{ms_eager:.2f} ms); COCO-80 detect_batch bs={BATCH} '
          f'{ref["batch"]["img_s"]:.1f} img/s  [{card}]')
    return ref


def _check_split_ranks(ranks, ref, backend, card) -> None:
    """Every rank's readings against the single-card references (and, over
    NCCL, the program route against the eager route); prints them."""
    world = len(ranks)
    nccl = backend == 'nccl'
    tag = f'{world} {backend} ranks' + ('' if nccl else ' on cuda:0')
    routes = ('program', 'eager') if nccl else ('eager',)
    tp, sd = ref['tp'], ref['detect']
    for i, r in enumerate(ranks):
        for part in ('tp', 'detect'):
            refused = r[part]['refused']
            if nccl:
                require(refused is None, f'[split ranks] {tag}: rank {i} '
                        f'refused the {part} program: {refused}')
            else:
                require(refused is not None and 'cannot capture' in refused,
                        f'[split ranks] {tag}: the {part} program route '
                        f'over gloo on the card did not raise')
        for name in routes:
            t, d = r['tp'][name], r['detect'][name]
            require(t['launches']['similarity'] == len(LEVELS)
                    and t['launches']['nms'] == 1,
                    f'[vocab tp] {tag} {name}: launches {t["launches"]}')
            require(d['launches']['similarity'] == len(LEVELS)
                    and d['launches']['nms'] == 1,
                    f'[spatial] {tag} {name}: launches {d["launches"]}')
        if nccl:
            err = _graph_diff(f'[vocab tp] {tag} rank {i} program vs eager',
                              r['tp']['program']['dets'],
                              r['tp']['eager']['dets'])
            _same_lists(f'[spatial] {tag} rank {i} program vs eager',
                        r['detect']['program']['dets'],
                        r['detect']['eager']['dets'])
            r['bit'] = err == 0.0 and r['detect']['program']['dets'] == \
                r['detect']['eager']['dets']
    r = ranks[0]
    for i, q in enumerate(ranks):   # every rank returns the same scores
        require(torch.equal(q['tp']['eager']['scores'],
                            r['tp']['eager']['scores']),
                f'[vocab tp] {tag}: rank {i} scores differ from rank 0')
    scores = r['tp']['eager']['scores'].cuda()
    ids = r['tp']['eager']['ids'].cuda()
    err = (scores - tp['scores']).abs().max().item()
    bad = ((ids != tp['ids']) & ~tp['tie']).sum().item()
    _, n, total = _check_split(
        f'[vocab tp] {tag}', r['tp']['eager']['dets'],
        {k: v.cpu() for k, v in tp['dets'].items()}, scores, tp['scores'],
        tp['names'], tp['topk'], VOCAB_TP_SCORE_ATOL)
    require(err <= VOCAB_TP_SCORE_ATOL and bad == 0,
            f'[vocab tp] {tag}: scores vs unsharded {err:.3e}, id '
            f'mismatches outside near-ties {bad}')
    t = {name: [q['tp'][name] for q in ranks] for name in routes}
    print(f'[vocab tp] {tag} ({r["mesh"]}), LVIS-1203 detect_batch bs='
          f'{BATCH}, classes split {world} ways, fp32: pre-NMS scores vs '
          f'the unsharded forward max|diff| {err:.3e} (tol '
          f'{VOCAB_TP_SCORE_ATOL:g}), id mismatches outside near-ties '
          f'{bad}; detections compared {n} of {total}; '
          + '; '.join(f'{name} img/s ' + ', '.join(
              f'{x["img_s"]:.1f}' for x in t[name]) + ' (rank order), '
              f'launches a call {t[name][0]["launches"]}' for name in routes)
          + (f'; program = eager bit for bit on every rank: '
             f'{all(q["bit"] for q in ranks)}; capture s '
             + ', '.join(f'{q["tp"]["capture_s"]}' for q in ranks)
             + '; graph pool GiB ' + ', '.join(
                 f'{q["tp"]["pool"]:.2f}' for q in ranks) if nccl else '')
          + f'; single-card program {tp["img_s"]:.1f} img/s  [{card}]')
    d = r['detect']['eager']
    delta = (r['detect']['scores'] - sd['scores']).abs().max().item()
    n, total = _check_detections(f'[spatial] {tag} detect()', d['dets'],
                                 sd['dets'], sd['scores'], delta,
                                 tp['topk'], SPATIAL_SCORE_ATOL)
    require(delta <= SPATIAL_SCORE_ATOL,
            f'[spatial] {tag}: pre-NMS scores vs unsplit {delta:.3e}')
    for i, q in enumerate(ranks):
        _same_lists(f'[spatial] {tag} rank {i} vs rank 0',
                    q['detect']['eager']['dets'], d['dets'])
    print(f'[spatial] {tag} ({r["mesh"]}), 640-px detect() split {world} '
          f'ways in height: pre-NMS scores vs unsplit max|diff| '
          f'{delta:.3e}; detections compared {n} of {total} (scores '
          f'{SPATIAL_SCORE_ATOL:g}, boxes {SPATIAL_BOX_PX:g} px); median ms '
          f'of {SPATIAL_TIMED} (rank order) ' + '; '.join(
              f'{name} ' + ', '.join(f'{q["detect"][name]["ms"]:.2f}'
                                     for q in ranks) for name in routes)
          + (f'; capture s ' + ', '.join(
              f'{q["detect"]["capture_s"]}' for q in ranks) if nccl else '')
          + ('; one traced call, device busy / span ms, idle share, NCCL '
             'kernels ms (rank order) ' + '; '.join(
                 f'{name} ' + ', '.join(
                     '{:.2f} / {:.2f}, {}, {:.2f}'.format(
                         t[0], t[1], _share(t[2]), t[3])
                     for t in (q['detect'][name]['trace'] for q in ranks))
                 for name in routes) if nccl else '')
          + f'; unsplit program {sd["ms"]:.2f} ms, its body eagerly '
          f'{sd["ms_eager"]:.2f} ms; the in-process split on one H100 '
          f'(every shard on cuda:0, PERF.md): 22.1 / 102.7 / 243.2 ms at '
          f'1 / 2 / 4 ways  [{card}]')
    if 'batch' not in r:
        return
    b, rb = ref['batch'], r['batch']
    for i, q in enumerate(ranks):
        q['bit2'] = 0.0 == _graph_diff(
            f'[spatial] {tag} 2x2 rank {i} program vs eager',
            q['batch']['program']['dets'], q['batch']['eager']['dets'])
        _graph_diff(f'[spatial] {tag} 2x2 rank {i} vs rank 0',
                    q['batch']['eager']['dets'], rb['eager']['dets'])
    delta, n, total = _check_split(
        f'[spatial] {tag} 2x2', rb['eager']['dets'],
        {k: v.cpu() for k, v in b['dets'].items()}, rb['scores'].cuda(),
        b['scores'], b['names'], tp['topk'], SPATIAL_SCORE_ATOL)
    require(delta <= SPATIAL_SCORE_ATOL,
            f'[spatial] {tag} 2x2: pre-NMS scores vs unsplit {delta:.3e}')
    print(f'[spatial] {tag} as a 2x2 grid, COCO-80 detect_batch bs={BATCH}, '
          f'batch over data x height over model: pre-NMS scores vs unsplit '
          f'max|diff| {delta:.3e}; detections compared {n} of {total}; '
          f'img/s (rank order) ' + '; '.join(
              f'{name} ' + ', '.join(f'{q["batch"][name]["img_s"]:.1f}'
                                     for q in ranks)
              for name in ('program', 'eager'))
          + f'; program = eager bit for bit on every rank: '
          f'{all(q["bit2"] for q in ranks)}; launches a call '
          f'{rb["program"]["launches"]}; single-card '
          f'program {b["img_s"]:.1f} img/s  [{card}]')


def phase_split_ranks(sim, nms, vocab_path, lvis_path, frames, tmp,
                      card) -> dict:
    """[split ranks]: the class-sharded forward (`make_sharded_inference`)
    and the spatial split (`spatialize_detector`) with one process a cell.
    Two gloo ranks on cuda:0: their eager route against the single-card
    programs ([vocab tp]'s and [spatial]'s bounds), the program route
    refused. With two cards or more, one NCCL rank a card on 1x2 and 1 x
    all grids (and 2x2 on four): the programs against the eager route and
    the single-card programs, img/s and detect() ms beside them, capture s
    and pool GiB. Returns the phase's launches, counted from 0."""
    out_dir = os.path.join(tmp, 'split')
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(lvis_path, os.path.join(out_dir, 'lvis.json'))
    shutil.copy(vocab_path, os.path.join(out_dir, 'coco.json'))
    _zero_counts(sim, nms)
    ref = _split_refs(sim, nms, vocab_path, lvis_path, frames, card)
    launches = _counts(sim, nms)
    runs = [(2, 'gloo')]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs += [(w, 'nccl') for w in sorted({2, cards})]
    for world, backend in runs:
        t0 = time.perf_counter()
        ranks = _run_ranks(world, backend, out_dir, kind='split')
        secs = time.perf_counter() - t0
        _check_split_ranks(ranks, ref, backend, card)
        print(f'[split ranks] {world} {backend} ranks ran in {secs:.1f} s '
              f'with their start-up  [{card}]')
        for q in ranks:
            for k, v in q['launches'].items():
                launches[k] = launches.get(k, 0) + v
    if cards < 2:
        print(f'[split ranks] one card: the NCCL programs across cards need '
              f'two cards or more  [{card}]')
    return launches


# ---------------------------------------------------------------------------
# [ckpt async]: a mid-training checkpoint saved without waiting
# ---------------------------------------------------------------------------

def _ckpt_diff(got, want, where: str = '') -> list:
    """The entries of two loaded checkpoints that are not bit-equal."""
    if isinstance(want, torch.Tensor):
        return [] if (isinstance(got, torch.Tensor)
                      and got.dtype == want.dtype
                      and torch.equal(got, want)) else [where]
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [where]
        return [d for k in want for d in _ckpt_diff(got[k], want[k],
                                                    f'{where}/{k}')]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [where]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _ckpt_diff(g, w, f'{where}/{i}')]
    return [] if got == want else [where]


CKPT_ROUNDS = 2


def phase_ckpt_async(tmp: str, card: str) -> None:
    """[ckpt async]: the clean bf16 trainer with an EMA on its train
    program (bs=DDP_BS, 640 px). Each round: save(wait=True) of the state,
    then save(wait=False) of the same state and at once one more step,
    which updates the parameters, the AdamW moments and the EMA in place
    on the same stream; once written, the async file equals the wait=True
    file tensor for tensor, and the live state has moved. Prints the step
    loop's stall of each save (the call's ms; with wait=False also the
    call and the next step together, beside a plain step) and the
    checkpoint's MiB."""
    from yoloclip_tpu_torch.train import train_state as ts
    from yoloclip_tpu_torch.train.trainer import YOLOCLIPTrainer
    from yoloclip_tpu_torch.utils import checkpoint as ckpt
    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, 'ckpt_async')
    cfg = _train_cfg(assigner='topk_center', dtype='bfloat16',
                     batch_size=DDP_BS, ema_decay=0.9999,
                     output_dir=out_dir)
    tr = YOLOCLIPTrainer(_seeded_model(cfg), None, cfg, device='cuda')
    ts.set_learning_rate(tr.state, cfg.learning_rate)
    arrays, text, _ = _ddp_batch()
    a, t = tr._put_batch(arrays), text.to(tr.device)

    def step():
        tr._train_step(tr.state, a, t)

    step()                                   # the capture
    plain = _steps_ms(step, 3)
    rounds = []
    for i in range(CKPT_ROUNDS):
        sync = os.path.join(out_dir, f'wait{i}', 'model.pt')
        later = os.path.join(out_dir, f'async{i}', 'model.pt')
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.save(sync, wait=True)
        wait_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        tr.save(later, wait=False)
        call_ms = (time.perf_counter() - t1) * 1e3
        step()
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        ckpt.finish_async_saves()
        finish_ms = (time.perf_counter() - t1) * 1e3
        want = torch.load(sync, map_location='cpu', weights_only=True)
        got = torch.load(later, map_location='cpu', weights_only=True)
        bad = _ckpt_diff(got, want)
        require(not bad, f'[ckpt async] round {i}: the wait=False file '
                f'differs from the wait=True file in {len(bad)} entries, '
                f'e.g. {bad[:3]}')
        live = tr.model.state_dict()
        moved = sum(not torch.equal(v.cpu(), want['model'][k])
                    for k, v in live.items() if v.is_floating_point())
        moved += sum(not torch.equal(v.cpu(), want['ema'][k])
                     for k, v in tr.state.ema.items())
        require(moved > 0, '[ckpt async] the step after the save moved '
                'nothing')
        with open(sync, 'rb') as f, open(later, 'rb') as g:
            same = f.read() == g.read()
        rounds.append(f'round {i}: wait=True {wait_ms:.1f} ms; wait=False '
                      f'{call_ms:.1f} ms, with the next step {loop_ms:.1f} '
                      f'ms, written {finish_ms:.1f} ms after that step; '
                      f'{moved} tensors moved by the step; files '
                      f'byte-identical {same}')
    mib = os.path.getsize(sync) / 2 ** 20
    print(f'[ckpt async] clean bf16 with EMA, bs={DDP_BS}, 640 px, the '
          f'train program (a plain step {plain:.2f} ms): a {mib:.1f} MiB '
          f'checkpoint; the wait=False file equals the wait=True file of '
          f'the pre-step state tensor for tensor; ' + '; '.join(rounds)
          + f'; phase {time.perf_counter() - t0:.1f} s  [{card}]')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yoloclip_tpu_torch import _build
    from yoloclip_tpu_torch.ops.kernels import int8_conv as i8
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, b16 = torch.float32, torch.bfloat16

    card = phase_device()
    phase_build(_build)
    k1_err = phase_kernel1(sim)
    nms_err = phase_kernel2(nms)
    k3_err = phase_kernel3(sim)
    shapes = eligible_shapes()
    i8_err = phase_int8_kernel(i8, shapes)
    lvis_vocab = phase_text(card)

    frames = _smoke_frames('cuda')
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, 'coco80_vocab.json')
        _write_vocab(vocab_path)
        det, bf, main_launches = phase_main_path(sim, nms, vocab_path, frames)
        phase_cross_device(det, vocab_path, frames)
        lvis_det, prompt_launches = phase_prompts(sim, nms, frames,
                                                  lvis_vocab)
        res = phase_timing(det, bf, lvis_det, frames, sim, nms, card)
        del lvis_det
        res_i8 = time_int8(i8, shapes, card)
        int8_launches, qbf = phase_int8_path(sim, nms, i8, det, bf,
                                             vocab_path, frames, card)
        graph_launches = phase_graphs(
            sim, nms, i8, (('float fp32', det), ('float bf16', bf),
                           ('int8 bf16', qbf)), frames, tmp, card)
        del qbf
        edge_launches, s8_err, res_s8 = phase_int8_edges(
            sim, nms, i8, vocab_path, frames, shapes, card)
        stem_launches = phase_stems(sim, nms, vocab_path, frames)
        t0 = time.perf_counter()
        export_launches = phase_export(sim, nms, i8, det, bf, vocab_path,
                                       frames, tmp, card)
        print(f'[export] phase seconds: {time.perf_counter() - t0:.1f}  '
              f'[{card}]')
        paths = [main_launches, prompt_launches, int8_launches,
                 graph_launches, edge_launches, stem_launches,
                 export_launches,
                 *phases_serving(sim, nms, det, bf, vocab_path, tmp, card),
                 phase_profile(sim, nms, bf, frames, tmp, card)]
        del det, bf
        paths.append(phases_training(sim, nms, tmp, card))
        paths.append(phase_train_graphs(sim, nms, tmp, card))
        phase_ckpt_async(tmp, card)
        gc.collect()
        torch.cuda.empty_cache()
        paths.append(phase_ddp(sim, nms, tmp, card))
        paths.append(phase_ddp_graphs(sim, nms, tmp, card))
        paths += phase_dp_serve(sim, nms, i8, vocab_path, tmp, card)
        # the 'model' axis: class parallelism and spatial partitioning
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        vtp, vk1, vk3 = phase_vocab_tp(sim, nms, i8, lvis_vocab, frames, tmp,
                                       card)
        k1_err[f32] = max(k1_err[f32], vk1)
        k3_err[f32] = max(k3_err[f32], vk3)
        t1 = time.perf_counter()
        paths += [vtp, phase_spatial(sim, nms, i8, vocab_path, frames, card)]
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        paths.append(phase_split_ranks(
            sim, nms, vocab_path, os.path.join(tmp, 'lvis_vocab.json'),
            frames, tmp, card))
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        phase_tp_train(tmp, card)
        t4 = time.perf_counter()
        phase_multihost(tmp, card)
        t5 = time.perf_counter()
        print(f'[model axis] phase seconds: [vocab tp] {t1 - t0:.1f}, '
              f'[spatial] {t2 - t1:.1f}, [split ranks] {t3 - t2:.1f}, '
              f'[tp train] {t4 - t3:.1f}, [multihost 4x2] {t5 - t4:.1f}  '
              f'[{card}]')
    # every path's launches, each counted from 0 just before it ran
    launched = {k: sum(p.get(k, 0) for p in paths)
                for k in ('similarity', 'similarity_bf16', 'nms',
                          'int8_conv', 'int8_conv_bf16',
                          'int8_conv_s8', 'int8_conv_s8_bf16',
                          'similarity_unprojected',
                          'similarity_unprojected_bf16')}

    require(not any(m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                        'yoloclip_tpu')
                    for m in sys.modules), 'the port imported JAX')

    def entry(name, source, replaces, timing, n, err):
        ms, _, plain, bms, bby, *lib = timing
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': n, 'max_abs_err': err,
                'ms': ms, 'plain_ms': plain, 'bound_ms': bms,
                'bound_by': bby, 'library_ms': lib[0] if lib else None}

    sim_src = 'yoloclip_tpu_torch/csrc/similarity.cu'
    k1, k3 = ('yoloclip_tpu/ops/pallas/similarity.py:240',
              'yoloclip_tpu/ops/pallas/similarity.py:110')
    kernels = [
        entry('fused_projected_similarity_argmax[float32]', sim_src, k1,
              res[('similarity', f32)], launched['similarity'],
              k1_err[f32]),
        entry('fused_projected_similarity_argmax[bfloat16]', sim_src, k1,
              res[('similarity', b16)], launched['similarity_bf16'],
              k1_err[b16]),
        entry('nms_keep', 'yoloclip_tpu_torch/csrc/nms.cu',
              'yoloclip_tpu/ops/pallas/nms.py:103', res[('nms', f32)],
              launched['nms'], nms_err),
        entry('fused_similarity_argmax[float32]', sim_src, k3,
              res[('unprojected', f32)],
              launched['similarity_unprojected'], k3_err[f32]),
        entry('fused_similarity_argmax[bfloat16]', sim_src, k3,
              res[('unprojected', b16)],
              launched['similarity_unprojected_bf16'], k3_err[b16]),
    ]
    for dt in (f32, b16):
        kernels.append(entry(
            f'int8_conv[{str(dt)[6:]}]',
            'yoloclip_tpu_torch/csrc/int8_conv.cu',
            'yoloclip_tpu/models/layers.py:269', res_i8[dt],
            launched['int8_conv' if dt == f32 else 'int8_conv_bf16'],
            i8_err[dt]))
    # the int8-input mode alone (its launches are also in the entries
    # above): the four edge readers of one forward
    for dt in (f32, b16):
        kernels.append(entry(
            f'int8_conv[int8 input, {str(dt)[6:]} output]',
            'yoloclip_tpu_torch/csrc/int8_conv.cu',
            'yoloclip_tpu/models/layers.py:269', res_s8[dt],
            launched['int8_conv_s8' if dt == f32 else 'int8_conv_s8_bf16'],
            s8_err[dt]))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
