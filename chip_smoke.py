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
                  the top kernels; StageTimer over the stages;
                  memory_stats();
 16. training  -- YOLOCLIPTrainer at variant 'n', 640 px, from seeded
                  weights on synthetic arrays (the card has no image
                  decoder): one compat fp32 AdamW step at bs=2 against the
                  same step in float64 on the CPU (loss parts, gradients,
                  BatchNorm buffers, parameters); at bs=16 with the 80
                  COCO prompts a sample, step ms, img/s and peak memory
                  for compat fp32, clean fp32 and clean bf16; evaluate
                  with NMS on 32 images (kernel 2); a torch.profiler
                  breakdown of one clean step (top 10 kernels, idle
                  share); the overfit twin of tests/test_convergence.py
                  (121 clean steps at 128 px, bs=4), served from its
                  checkpoint by YOLOCLIPDetector (kernels 1 and 2): one
                  box per image, class 0, IoU >= 0.5; then cli.eval on
                  those images written as PNG files, where the machine
                  can decode them (it says so where it cannot).
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
                  rank's rows (kernels 1 and 2 in each);
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
 21. tp train  -- two gloo ranks on cuda:0 as a 1x2 (data x model) grid:
                  one compat fp32 class-sharded step at 640 px, bs=16,
                  against the 1-process step with [ddp]'s bounds;
 22. multihost -- the self-test (`parallel/multihost.py --selftest --model
                  2`) in 8 processes on cuda:0 (gloo) as a 4x2 grid, each
                  loss against the 1-process self-test.
Each path that launches kernels (main path, prompts, int8, stems, export,
canvas,
server, streaming, reparam, profile, training, the ddp ranks, dp serve,
vocab tp, spatial) runs with the launch counters set to 0 just before it and read just after;
the kernels line sums them. Two ranks or replicas on one card show
correctness, not scaling.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
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
    for sym in ('yc_int8_conv_f32', 'yc_int8_conv_bf16'):
        require(hasattr(lib, sym), f'symbol {sym} missing')
    counts = _sass_gmma(_build.BUILD_DIR / 'libint8_conv.so', 'IGMMA')
    for fn, n in counts.items():
        print(f'[build] SASS of int8_conv_wgmma<'
              f'{"bf16" if "bfloat16" in fn else "fp32"}, '
              f'{"256" if "Li256E" in fn else "128"}>: {n} IGMMA (int8 '
              f'wgmma) instructions')
    require(len(counts) == 4 and all(counts.values())
            and {'bfloat16' in fn for fn in counts} == {True, False},
            'an int8_conv instantiation (fp32 or bf16 input, 128 or 256 '
            'channels a block) has no int8 wgmma instruction')


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


def _img_per_s(det, frames, iters: int = 10) -> float:
    return frames.shape[0] / _synced_ms(lambda: det.detect_batch(frames),
                                        iters) * 1e3


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
    print(f'[time] detect_batch bs={BATCH} 640px COCO-80 variant n, frames '
          f'480x640 uint8 already on the card, conf 0.25: '
          f'fp32 {fp32:.1f} img/s (peak {peak:.2f} GiB), '
          f'bf16 {bf16:.1f} img/s  [{card}]')
    lvis = _img_per_s(lvis_det, frames)
    print(f'[time] detect_batch bs={BATCH} 640px LVIS-scale {LVIS_C} '
          f'classes (folded path) fp32: {lvis:.1f} img/s  [{card}]')
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
    i8.launches = i8.launches_bf16 = 0


def _int8_card_vs_cpu(card_model, cpu_model, x, text):
    """The int8 model on the card (fused scoring) and on the CPU on the
    same input, twice on the CPU: free-running, and with every int8
    block's input forced to the card's (forward pre-hooks). Returns
    (rounding flips at the int8 blocks' inputs when free-running, values
    in all, the worst relative difference of an int8 block's output given
    the same input, card output, free CPU output, forced CPU output)."""
    from yoloclip_tpu_torch.models.layers import ConvBlock
    from yoloclip_tpu_torch.ops.kernels.int8_conv import quantize_plain
    ins, outs = {}, {}

    def record(side):
        def rec(mod, args, out):
            ins.setdefault(side, {})[mod.name] = args[0].cpu()
            outs.setdefault(side, {})[mod.name] = out.cpu()
        return rec

    def force(mod, args):
        return (ins['card'][mod.name],)

    blocks = {side: [(n, m) for n, m in model.named_modules()
                     if isinstance(m, ConvBlock) and m.mode == 'int8']
              for side, model in (('card', card_model), ('cpu', cpu_model))}
    for side in blocks:
        for n, m in blocks[side]:
            m.name = n
    with torch.inference_mode():
        hooks = [m.register_forward_hook(record('card'))
                 for _, m in blocks['card']]
        got = card_model(x, text.cuda(), fused_scores=True)
        for h in hooks:
            h.remove()
        hooks = [m.register_forward_hook(record('free'))
                 for _, m in blocks['cpu']]
        free = cpu_model(x.cpu(), text.cpu())
        for h in hooks:
            h.remove()
        hooks = [m.register_forward_pre_hook(force) for _, m in blocks['cpu']]
        hooks += [m.register_forward_hook(record('forced'))
                  for _, m in blocks['cpu']]
        forced = cpu_model(x.cpu(), text.cpu())
        for h in hooks:
            h.remove()
    flips = total = 0
    worst = 0.0
    for n, m in blocks['cpu']:
        a = quantize_plain(ins['card'][n], m.act_scale)
        flips += int((a != quantize_plain(ins['free'][n], m.act_scale)).sum())
        total += a.numel()
        want = outs['forced'][n]
        # |diff| <= rel |want| + atol with rel = atol: |diff| / (|want| + 1)
        worst = max(worst, ((outs['card'][n] - want).abs()
                            / (want.abs() + 1)).max().item())
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
    Returns the launches of the path."""
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
    for name, d in (('float fp32', det), ('int8 fp32', q32),
                    ('int8 bf16', qbf), ('float bf16', bf)):
        rates[name] = _img_per_s(d, frames)
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
    return {k: launches[k] + srv_launches[k] for k in launches}


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
    """img/s of each detector's detect_batch with each kernel's
    implementation called straight, as the port's eager calls do, and
    through the custom ops (`KernelOp.__call__` swapped for the
    measurement), in turns; medians over the rounds. Also the host time
    of one small kernel-2 call both ways."""
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
                    rates[(name, direct)].append(_img_per_s(det, frames))
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
              f'{B / eager_ms * 1e3:.1f} img/s on the same canvases, eager '
              f'detect_batch {rate:.1f} img/s  [{card}]')
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
        print(f'[train] {assigner} {dtype} bs={TRAIN_BS} 640 px: '
              f'{ms:.2f} ms/step, {TRAIN_BS / ms * 1e3:.1f} img/s, peak '
              f'{peak:.2f} GiB, loss {losses["loss"]:.4f} ({card})')
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
            _step_breakdown(trainer, batch, card, f'clean {dtype}')
        del trainer


def phase_overfit(tmp: str) -> None:
    """The twin of tests/test_convergence.py on the card: 121 clean steps
    at 128 px, bs=4, on 4 images of one white square, the lr on the
    trainer's OneCycle curve (step units, peak 2e-3 at the first step);
    the loss must fall below 0.25 of the first step's; the checkpoint,
    served by YOLOCLIPDetector at conf 0.25 (kernels 1 and 2), must find
    exactly the square in each image, class 0, IoU >= 0.5. (The JAX test
    holds the lr at 2e-3: its detections then hang on the last steps'
    oscillation, and a 1e-6 change of its initial weights turns one
    image's one box into two; annealed, six of six initial states passed
    on the CPU.)"""
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    from yoloclip_tpu_torch.ops.boxes import pairwise_iou
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
    sched = ts.make_onecycle_schedule(2e-3, OVERFIT_STEPS + 1, 1)
    textb = text[None].expand(B, -1, -1).cuda()
    t = time.perf_counter()
    ts.set_learning_rate(state, sched(0))
    first = step(state, batch, textb)['loss'].item()
    for i in range(1, OVERFIT_STEPS + 1):
        ts.set_learning_rate(state, sched(i))
        parts = step(state, batch, textb)
    last = parts['loss'].item()
    secs = time.perf_counter() - t
    path = os.path.join(tmp, 'overfit.pt')
    save_checkpoint(path, state.model.state_dict(), step=state.step)
    vocab = os.path.join(tmp, 'overfit_vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'square': text[0].tolist(), 'other': text[1].tolist()}, f)
    det = YOLOCLIPDetector(
        InferenceConfig(model=cfg.model, conf_threshold=0.25,
                        iou_threshold=0.45, nms_topk=256, max_detections=8,
                        host_preprocess=False),
        vocab_path=vocab, model_path=path, device='cuda', seed=0)
    out = det.detect_batch(torch.from_numpy(
        (img * 255).astype(np.uint8)).cuda())
    ious = []
    for b in range(B):
        require(int(out['count'][b]) == 1,
                f'overfit image {b}: {int(out["count"][b])} detections')
        require(int(out['class_ids'][b][0]) == 0, f'overfit image {b} class')
        ious.append(float(pairwise_iou(
            out['boxes'][b][:1].cpu(), torch.from_numpy(boxes[b, :1]))[0, 0]))
    print(f'[overfit] {OVERFIT_STEPS + 1} clean steps at 128 px bs=4 in '
          f'{secs:.1f} s: loss {first:.4f} -> {last:.4f} (must fall below '
          f'{0.25 * first:.4f}); detect_batch: one box per image, class 0, '
          f'IoU {", ".join(f"{i:.3f}" for i in ious)}')
    require(last < 0.25 * first, 'overfit loss did not fall below 0.25x')
    require(min(ious) >= 0.5, 'overfit detection IoU below 0.5')
    return img, boxes, path, vocab


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
    print(f'[train] launches on the training path (evaluate, overfit '
          f'detect_batch, cli.eval where it ran): {launches}')
    require(launches['nms'] > 0 and launches['similarity'] > 0,
            'the training path did not launch kernels 1 and 2')
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
              backend: str) -> None:
    """One rank of the [ddp] phase on cuda:0: each DDP_STEPS step on its
    rows of the global batch (world 1: the fp32 step only), then with two
    ranks `evaluate` with NMS (kernel 2) on DDP_EVAL_IMAGES images and
    `make_sharded_inference` with the folded scoring (kernel 1) on its
    rows. Writes out_dir/rank{rank}.pt."""
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
                         device='cuda:0', backend=backend,
                         timeout_s=DDP_TIMEOUT_S)
    mesh = create_mesh()
    out = {'backend': backend, 'mesh': repr(mesh)}
    arrays, text, prompts = _ddp_batch()
    for tag, assigner, dtype in DDP_STEPS[:1 if world == 1 else None]:
        cfg = _train_cfg(assigner=assigner, dtype=dtype, batch_size=DDP_BS)
        state = ts.create_train_state(_seeded_model(cfg), cfg, 'cuda:0')
        ts.set_learning_rate(state, cfg.learning_rate)
        step = make_sharded_train_step(cfg, mesh)(state)
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
        run = make_sharded_inference(model, mesh)
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


def _run_ranks(world: int, backend: str, out_dir: str) -> list:
    """Spawn `world` [ddp] ranks, wait for them (failing the run past
    DDP_TIMEOUT_S or on any rank's error) and load their results."""
    import torch.multiprocessing as mp
    rdv = os.path.join(out_dir, f'rendezvous_{backend}_{world}')
    ctx = mp.start_processes(_ddp_rank, args=(world, rdv, out_dir, backend),
                             nprocs=world, join=False, start_method='spawn')
    deadline = time.perf_counter() + DDP_TIMEOUT_S + 120
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


def _compare_step(tag, assigner, dtype, got, want, card, label='[ddp]'):
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
    print(f'{label} {tag} bs={DDP_BS} 640 px, 2 ranks (gloo, both on cuda:0) '
          f'vs 1 process on the card{extra}: loss parts max rel '
          f'{loss_err:.3e} (tol {loss_tol:g}); gradients rel L2 over all '
          f'{grad_all:.3e} (tol {grad_tol:.3e}), worst tensor {grad_err:.3e} '
          f'({worst}); BatchNorm buffers max abs {buf_err:.3e} '
          f'(tol {buf_tol:.3e}); parameters vs AdamW on the ranks\' gradients '
          f'max abs {param_err:.3e} (tol {TRAIN_PARAM_ATOL:g}); ranks\' '
          f'parameters identical={got["identical"]}; step {got["ms"]:.2f} '
          f'ms a rank (two ranks sharing one card: correctness, not scaling)'
          f' vs {ms:.2f} ms in one process  [{card}]')
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
          f's with their start-up')
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
    events; the device's idle share of 10 calls read from it; StageTimer
    over its stages. Returns the launches of the traced calls."""
    from yoloclip_tpu_torch.ops.nms import batched_nms
    from yoloclip_tpu_torch.ops.preprocess import (letterbox_batch_for,
                                                   rescale_boxes)
    from yoloclip_tpu_torch.utils.profiling import (StageTimer, annotate,
                                                    device_summary,
                                                    memory_stats, trace)
    _zero_counts(sim, nms)
    for _ in range(3):
        bf.detect_batch(frames)
    torch.cuda.synchronize()
    per_call = {k: v // 3 for k, v in _counts(sim, nms).items()}
    _zero_counts(sim, nms)
    log_dir = os.path.join(tmp, 'trace')
    with trace(log_dir) as prof:
        with annotate('detect_batch x10'):
            for _ in range(10):
                bf.detect_batch(frames)
            torch.cuda.synchronize()
    launches = _counts(sim, nms)
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

    st = StageTimer()
    text, _ = bf._text(None)
    with torch.inference_mode():
        for i in range(13):
            if i == 3:
                st.reset()
            with st.stage('letterbox'):
                canv, scale = st.observe(letterbox_batch_for(bf.config.model)(
                    frames, bf.image_size))
            with st.stage('model (folded scoring)'):
                out = st.observe(bf.model(canv, text, fused_scores=True))
            with st.stage('rescale + NMS'):
                st.observe(batched_nms(
                    rescale_boxes(out['boxes'], scale,
                                  tuple(frames.shape[1:3])),
                    out['scores'], out['class_ids'], **bf._nms_args()))
    print('[profile] StageTimer, bf16 detect_batch stages, mean of 10 '
          '(synchronised at each stage exit): ' + ', '.join(
              f'{k} {v["mean_ms"]:.2f} ms' for k, v in st.summary().items())
          + f'  [{card}]')
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
    step = make_sharded_train_step(cfg, mesh)(state)
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

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (BATCH, 480, 640, 3), dtype=np.uint8)).cuda()
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
        int8_launches = phase_int8_path(sim, nms, i8, det, bf, vocab_path,
                                        frames, card)
        stem_launches = phase_stems(sim, nms, vocab_path, frames)
        t0 = time.perf_counter()
        export_launches = phase_export(sim, nms, i8, det, bf, vocab_path,
                                       frames, tmp, card)
        print(f'[export] phase seconds: {time.perf_counter() - t0:.1f}  '
              f'[{card}]')
        paths = [main_launches, prompt_launches, int8_launches,
                 stem_launches, export_launches,
                 *phases_serving(sim, nms, det, bf, vocab_path, tmp, card),
                 phase_profile(sim, nms, bf, frames, tmp, card)]
        del det, bf
        paths.append(phases_training(sim, nms, tmp, card))
        paths.append(phase_ddp(sim, nms, tmp, card))
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
        phase_tp_train(tmp, card)
        t3 = time.perf_counter()
        phase_multihost(tmp, card)
        t4 = time.perf_counter()
        print(f'[model axis] phase seconds: [vocab tp] {t1 - t0:.1f}, '
              f'[spatial] {t2 - t1:.1f}, [tp train] {t3 - t2:.1f}, '
              f'[multihost 4x2] {t4 - t3:.1f}  [{card}]')
    # every path's launches, each counted from 0 just before it ran
    launched = {k: sum(p.get(k, 0) for p in paths)
                for k in ('similarity', 'similarity_bf16', 'nms',
                          'int8_conv', 'int8_conv_bf16',
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
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
