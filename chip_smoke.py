#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yoloclip_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and the repository checkout; imports no JAX.
Phases, each printing its results; any failure exits non-zero:

  1. device    -- the card's name and power limit (nvidia-smi);
  2. build     -- compile both CUDA sources from yoloclip_tpu_torch/csrc/
                  (one nvcc each, in parallel), ptxas's report, and the
                  count of tensor-core (HGMMA) instructions in the SASS of
                  each similarity instantiation (cuobjdump; none fails);
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
                  alone and the NMS stage also by CUDA-graph replay).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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
    print(f'[build] similarity.cu and nms.cu built from {_build.CSRC} in '
          f'{time.time() - t:.2f} s (parallel nvcc)')
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


def _sass_gmma(lib_path) -> dict:
    """HGMMA instructions in each kernel of a built library (cuobjdump)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if 'Function :' in ln:
            fn = ln.split('Function :')[1].strip()
            counts[fn] = 0
        elif fn is not None and 'HGMMA' in ln:
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


def _detector(vocab_path, dtype='float32'):
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    cfg = InferenceConfig(host_preprocess=False)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=dtype))
    return YOLOCLIPDetector(cfg, vocab_path=vocab_path, device='cuda', seed=0)


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


def _img_per_s(det, frames, iters: int = 10) -> float:
    for _ in range(3):
        det.detect_batch(frames)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        det.detect_batch(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return frames.shape[0] / statistics.median(times)


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


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this run '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yoloclip_tpu_torch import _build
    from yoloclip_tpu_torch.ops.kernels import nms, similarity as sim

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device()
    phase_build(_build)
    k1_err = phase_kernel1(sim)
    nms_err = phase_kernel2(nms)
    k3_err = phase_kernel3(sim)
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

    require(not any(m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                        'yoloclip_tpu')
                    for m in sys.modules), 'the port imported JAX')

    def entry(name, source, replaces, key, n, err):
        ms, _, plain, bms, bby = res[key]
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': n, 'max_abs_err': err,
                'ms': ms, 'plain_ms': plain, 'bound_ms': bms,
                'bound_by': bby, 'library_ms': None}

    f32, b16 = torch.float32, torch.bfloat16
    sim_src = 'yoloclip_tpu_torch/csrc/similarity.cu'
    k1, k3 = ('yoloclip_tpu/ops/pallas/similarity.py:240',
              'yoloclip_tpu/ops/pallas/similarity.py:110')
    kernels = [
        entry('fused_projected_similarity_argmax[float32]', sim_src, k1,
              ('similarity', f32), main_launches['similarity'], k1_err[f32]),
        entry('fused_projected_similarity_argmax[bfloat16]', sim_src, k1,
              ('similarity', b16), main_launches['similarity_bf16'],
              k1_err[b16]),
        entry('nms_keep', 'yoloclip_tpu_torch/csrc/nms.cu',
              'yoloclip_tpu/ops/pallas/nms.py:103', ('nms', f32),
              main_launches['nms'], nms_err),
        entry('fused_similarity_argmax[float32]', sim_src, k3,
              ('unprojected', f32),
              prompt_launches['similarity_unprojected'], k3_err[f32]),
        entry('fused_similarity_argmax[bfloat16]', sim_src, k3,
              ('unprojected', b16),
              prompt_launches['similarity_unprojected_bf16'], k3_err[b16]),
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
