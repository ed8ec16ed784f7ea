#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yoloclip_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and the repository checkout; imports no JAX.
Phases, each printing its results; any failure exits non-zero:

  1. device    -- the card's name and power limit (nvidia-smi);
  2. build     -- compile both CUDA sources from yoloclip_tpu_torch/csrc/
                  (one nvcc each, in parallel), ptxas's report;
  3. kernel 1  -- folded similarity max/argmax vs its plain PyTorch version
                  at the main-path shapes, fp32 (TF32 off) and bf16;
  4. kernel 2  -- greedy NMS keep mask vs its plain version, bit for bit;
  5. kernel 3  -- unprojected similarity max/argmax vs its plain version at
                  B=32, A=8400, E=512, C=80 and 1203, fp32 and bf16,
                  normalize_obj both ways, num_valid < C, a duplicated text
                  row, a zero obj row;
  6. text      -- the full-width CLIP text tower (12 x 512, seeded) on the
                  card vs the same weights on the CPU for 16 prompts; a
                  1203-class vocabulary build (6015 prompts) timed in fp32
                  and bf16 with its peak memory;
  7. main path -- YOLOCLIPDetector at variant 'n', 640x640, COCO-80 JSON
                  vocabulary, random weights from a seed: detect_batch on 32
                  frames of 480x640 at conf 0.25 and -1.0, detect on one
                  frame; kernels 1 and 2 must have launched; outputs finite;
                  a bs=2 fp32 run on the card against the same run on CPU;
  8. prompts   -- the LVIS-scale prompt path: YOLOCLIPDetector from 1203
                  class names (vocabulary built by the text tower on the
                  card), the unfolded scoring (model unfused + kernel 3 on
                  its obj_embeddings) against the model's own scores and the
                  folded kernel-1 run, then detect_batch and detect with
                  five free-text prompts; all three kernels must launch;
  9. timing    -- detect_batch images/s (COCO-80 fp32 and bf16, LVIS-1203
                  fp32) and each kernel beside its plain version and its
                  bound (CUDA events).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
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

# The H100 SXM's published peaks (dense) and memory rate: the bound of a
# kernel is the larger of its operations over the peak for its input type
# and its bytes (inputs read once, outputs written once) over HBM.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(flops: float, nbytes: float, dtype: torch.dtype):
    """(least time in ms, 'operations' or 'bytes')."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


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


def _sim_inputs(g, A, C, dtype):
    h = torch.randn(BATCH, A, HIDDEN, device='cuda', generator=g)
    h[0, 3] = 0.0                        # zero hidden row: norm = ||b||
    K = torch.randn(HIDDEN, EMBED, device='cuda', generator=g) / 16
    b = 0.1 * torch.randn(EMBED, device='cuda', generator=g)
    t = torch.randn(BATCH, C, EMBED, device='cuda', generator=g)
    t = t / t.norm(dim=-1, keepdim=True)
    t[:, 7] = t[:, 3]                    # exact tie: class 3 must win
    return h.to(dtype), t, K, b


def phase_kernel1(sim) -> float:
    g = torch.Generator(device='cuda').manual_seed(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for A, C in [(a, 80) for a in LEVELS] + [(LEVELS[0], 1203)]:
            h, t, K, b = _sim_inputs(g, A, C, dtype)
            s, i = sim.fused_projected_similarity_argmax(h, t, K, b)
            ps, pi = sim.similarity_argmax_plain(h, t, K, b)
            tp, cb = sim._fold_text(t, K, b, dtype)
            raw = torch.matmul(h.float(), tp.float().transpose(1, 2)) \
                + cb[:, None]
            norm = (torch.matmul(h.float(), K.to(dtype).float()) + b).norm(
                dim=-1).clamp_min(1e-12)
            top2 = raw.topk(2, dim=-1).values
            tie = (top2[..., 0] - top2[..., 1]) / norm < SIM_ATOL
            torch.cuda.synchronize()
            err = (s - ps).abs().max().item()
            bad = ((i != pi) & ~tie).sum().item()
            worst = max(worst, err)
            print(f'[kernel1] {str(dtype)[6:]:8s} B={BATCH} A={A:5d} C={C:4d}'
                  f' max|score-plain|={err:.3e} (tol {SIM_ATOL:g}) '
                  f'id mismatches outside near-ties={bad} '
                  f'near-tie anchors exempt={int(tie.sum())}')
            require(err <= SIM_ATOL, 'kernel 1 scores disagree')
            require(bad == 0, 'kernel 1 ids disagree')
            require(not (i == 7).any().item(), 'kernel 1 tie order')
    return worst


def _nms_scene(g, B, K):
    c = torch.rand(B, K, 2, device='cuda', generator=g) * 200
    half = K // 2
    c[:, half:] = c[:, :K - half] + torch.randn(
        B, K - half, 2, device='cuda', generator=g) * 12
    wh = 20 + torch.rand(B, K, 2, device='cuda', generator=g) * 60
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


def phase_kernel2(nms) -> float:
    g = torch.Generator(device='cuda').manual_seed(2)
    chain = torch.tensor([[i * 5.0, 0.0, i * 5.0 + 10.0, 10.0]
                          for i in range(64)], device='cuda')
    cases = [('overlap K=1024 all valid', _nms_scene(g, BATCH, 1024), 1.0,
              0.45),
             ('overlap K=1024 half valid', _nms_scene(g, BATCH, 1024), 0.5,
              0.45),
             ('64-box chain', chain[None].repeat(BATCH, 1, 1), 1.0, 0.3)]
    worst = 0.0
    for name, boxes, frac, thr in cases:
        valid = torch.rand(boxes.shape[:2], device='cuda', generator=g) < frac
        keep = nms.nms_keep(boxes, valid, thr)
        want = nms.nms_keep_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        same = torch.equal(keep, want)
        worst = max(worst, (keep.float() - want.float()).abs().max().item())
        print(f'[kernel2] {name}: B={boxes.shape[0]} keep masks '
              f'bit-identical={same} kept={int(keep.sum())}')
        require(same, f'kernel 2 keep mask differs ({name})')
    require(bool(keep[:, ::2].all()) and not bool(keep[:, 1::2].any()),
            'kernel 2 chain: greedy keeps every other box')
    return worst


def _obj_inputs(g, C, dtype, normalize_obj):
    """obj (B, 8400, 512) in `dtype` (unit rows unless normalize_obj; row
    (0, 3) zero) and unit text (B, C, 512) with row 7 a copy of row 3."""
    obj = torch.randn(BATCH, ANCHORS, EMBED, device='cuda', generator=g)
    if not normalize_obj:
        obj = obj / obj.norm(dim=-1, keepdim=True)
    obj[0, 3] = 0.0
    t = torch.randn(BATCH, C, EMBED, device='cuda', generator=g)
    t = t / t.norm(dim=-1, keepdim=True)
    t[:, 7] = t[:, 3]                    # exact tie: class 3 must win
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
    top2 = raw.topk(2, dim=-1).values
    norm = obj.float().norm(dim=-1).clamp_min(1e-12)
    tie = (top2[..., 0] - top2[..., 1]) / norm < SIM_ATOL
    del raw
    torch.cuda.synchronize()
    err = (s - ps).abs().max().item()
    bad = ((i != pi) & ~tie).sum().item()
    print(f'[kernel3] {tag}: max|score-plain|={err:.3e} (tol {SIM_ATOL:g}) '
          f'id mismatches outside near-ties={bad} near-tie anchors '
          f'exempt={int(tie.sum())}')
    require(err <= SIM_ATOL, f'kernel 3 scores disagree ({tag})')
    require(bad == 0, f'kernel 3 ids disagree ({tag})')
    require(not (i == 7).any().item(), f'kernel 3 tie order ({tag})')
    require(s[0, 3].item() == 0.0 and i[0, 3].item() == 0,
            f'kernel 3 zero obj row ({tag})')
    if num_valid is not None:
        require(bool((i < num_valid).all()), f'kernel 3 num_valid ({tag})')
    return err


def phase_kernel3(sim) -> float:
    g = torch.Generator(device='cuda').manual_seed(4)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for C in (80, LVIS_C):
            for normalize_obj in (True, False):
                obj, t = _obj_inputs(g, C, dtype, normalize_obj)
                tag = (f'{str(dtype)[6:]:8s} B={BATCH} A={ANCHORS} '
                       f'E={EMBED} C={C:4d} normalize_obj={normalize_obj}')
                worst = max(worst, _check_unprojected(
                    sim, obj, t, None, normalize_obj, tag))
                if C == LVIS_C and normalize_obj:
                    worst = max(worst, _check_unprojected(
                        sim, obj, t, C - 17, True, tag + f' num_valid={C - 17}'))
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


def phase_main_path(sim, nms, vocab_path, frames):
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    cfg = InferenceConfig(host_preprocess=False)
    det = YOLOCLIPDetector(cfg, vocab_path=vocab_path, device='cuda', seed=0)
    require(len(det.class_names) == 80, 'COCO-80 vocabulary')

    sim.launches = 0
    nms.launches = 0
    out = det.detect_batch(frames)
    det.conf_threshold = -1.0
    out_all = det.detect_batch(frames)
    det.conf_threshold = cfg.conf_threshold
    dets = det.detect(frames[0].cpu().numpy())
    torch.cuda.synchronize()
    launches = {'similarity': sim.launches, 'nms': nms.launches}
    print(f'[main] launches on the main path: {launches}')
    require(all(n > 0 for n in launches.values()),
            'a kernel of the main path never launched')

    D = cfg.max_detections
    for name, o in (('conf 0.25', out), ('conf -1.0', out_all)):
        require(o['boxes'].shape == (BATCH, D, 4), 'detect_batch shape')
        require(_finite(o), 'non-finite detect_batch output')
        print(f'[main] detect_batch {name}: counts '
              f'min={int(o["count"].min())} max={int(o["count"].max())} '
              f'saturated={int(o["prefilter_saturated"].sum())}/{BATCH}')
    require(bool(out_all['prefilter_saturated'].all()),
            'conf -1.0 must saturate the 1024-candidate prefilter')
    require(bool((out_all['count'] > 0).all()), 'conf -1.0 keeps boxes')
    require(all(np.isfinite(d['score']) for d in dets), 'detect scores')
    print(f'[main] detect on one 480x640 frame: {len(dets)} detections')
    return det


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

    sim.launches = sim.unprojected_launches = nms.launches = 0
    alpha, beta = cfg.model.cls_alpha, cfg.model.cls_beta
    with torch.inference_mode():
        canv, _ = letterbox_batch(frames, det.image_size)
        unf = det.model(canv, det.offline_vocabulary)
        txt = unf['text_embeddings']
        txt = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        s3, i3 = sim.fused_similarity_argmax(unf['obj_embeddings'], txt,
                                             normalize_obj=True)
        s3 = alpha * s3 + beta
        folded = det.model(canv, det.offline_vocabulary, fused_scores=True)
    out = det.detect_batch(frames)
    dets = det.detect(frames[0].cpu().numpy(), text_prompts=FREE_PROMPTS)
    torch.cuda.synchronize()
    launches = {'similarity': sim.launches,
                'similarity_unprojected': sim.unprojected_launches,
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


def phase_timing(det, lvis_det, vocab_path, frames, sim, nms, card: str):
    from yoloclip_tpu_torch.config import InferenceConfig
    from yoloclip_tpu_torch.inference.detector import YOLOCLIPDetector
    torch.cuda.reset_peak_memory_stats()
    fp32 = _img_per_s(det, frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = InferenceConfig(host_preprocess=False)
    bf = YOLOCLIPDetector(
        dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dtype='bfloat16')),
        vocab_path=vocab_path, device='cuda', seed=0)
    bf16 = _img_per_s(bf, frames)
    del bf
    print(f'[time] detect_batch bs={BATCH} 640px COCO-80 variant n, frames '
          f'480x640 uint8 already on the card, conf 0.25: '
          f'fp32 {fp32:.1f} img/s (peak {peak:.2f} GiB), '
          f'bf16 {bf16:.1f} img/s  [{card}]')
    lvis = _img_per_s(lvis_det, frames)
    print(f'[time] detect_batch bs={BATCH} 640px LVIS-scale {LVIS_C} '
          f'classes (folded path) fp32: {lvis:.1f} img/s  [{card}]')

    g = torch.Generator(device='cuda').manual_seed(3)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot_k = tot_p = 0.0
        for A in LEVELS:
            h, t, K, b = _sim_inputs(g, A, 80, dtype)
            mk = cuda_ms(lambda: sim.fused_projected_similarity_argmax(
                h, t, K, b))
            mp = cuda_ms(lambda: sim.similarity_argmax_plain(h, t, K, b))
            tot_k += mk
            tot_p += mp
            print(f'[time] similarity {str(dtype)[6:]:8s} B={BATCH} A={A:5d}'
                  f' C=80: kernel {mk:.3f} ms, plain {mp:.3f} ms')
        esize = torch.finfo(dtype).bits // 8
        flops = 2 * BATCH * ANCHORS * HIDDEN * (80 + EMBED)
        nbytes = (BATCH * ANCHORS * HIDDEN * esize + BATCH * 80 * EMBED * 4
                  + HIDDEN * EMBED * 4 + EMBED * 4 + BATCH * ANCHORS * 8)
        bms, bby = bound(flops, nbytes, dtype)
        print(f'[time] similarity {str(dtype)[6:]} all three levels: kernel '
              f'{tot_k:.3f} ms, plain {tot_p:.3f} ms, bound {bms:.4f} ms '
              f'({bby})  [{card}]')
        res[('similarity', dtype)] = (tot_k, tot_p, bms, bby)
        del h, t

    for dtype in (torch.float32, torch.bfloat16):
        obj, t = _obj_inputs(g, LVIS_C, dtype, True)
        mk = cuda_ms(lambda: sim.fused_similarity_argmax(
            obj, t, normalize_obj=True), iters=10)
        mp = cuda_ms(lambda: sim.similarity_argmax_reference_plain(
            obj, t, None, True), iters=10)
        esize = torch.finfo(dtype).bits // 8
        flops = 2 * BATCH * ANCHORS * EMBED * LVIS_C
        nbytes = (BATCH * ANCHORS * EMBED * esize
                  + BATCH * LVIS_C * EMBED * 4 + BATCH * ANCHORS * 8)
        bms, bby = bound(flops, nbytes, dtype)
        print(f'[time] similarity unprojected {str(dtype)[6:]} B={BATCH} '
              f'A={ANCHORS} E={EMBED} C={LVIS_C} normalize_obj: kernel '
              f'{mk:.3f} ms, plain {mp:.3f} ms, bound {bms:.4f} ms ({bby})'
              f'  [{card}]')
        res[('unprojected', dtype)] = (mk, mp, bms, bby)
        del obj, t

    boxes = _nms_scene(g, BATCH, 1024)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device='cuda')
    mk = cuda_ms(lambda: nms.nms_keep(boxes, valid, 0.45))
    mp = cuda_ms(lambda: nms.nms_keep_plain(boxes, valid, 0.45), iters=5)
    # ~12 fp32 operations per IoU pair (i < j); boxes, valid, keep once
    pairs = BATCH * 1024 * 1023 // 2
    bms, bby = bound(12 * pairs, BATCH * 1024 * (16 + 1 + 1), torch.float32)
    print(f'[time] nms keep B={BATCH} K=1024: kernel {mk:.3f} ms, '
          f'plain {mp:.3f} ms, bound {bms:.4f} ms ({bby})  [{card}]')
    res[('nms', torch.float32)] = (mk, mp, bms, bby)
    return res


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
    sim_err = phase_kernel1(sim)
    nms_err = phase_kernel2(nms)
    k3_err = phase_kernel3(sim)
    lvis_vocab = phase_text(card)

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (BATCH, 480, 640, 3), dtype=np.uint8)).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, 'coco80_vocab.json')
        _write_vocab(vocab_path)
        det = phase_main_path(sim, nms, vocab_path, frames)
        phase_cross_device(det, vocab_path, frames)
        lvis_det, launches = phase_prompts(sim, nms, frames, lvis_vocab)
        res = phase_timing(det, lvis_det, vocab_path, frames, sim, nms, card)

    require(not any(m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                        'yoloclip_tpu')
                    for m in sys.modules), 'the port imported JAX')

    def entry(name, source, replaces, key, n, err):
        ms, plain, bms, bby = res[key]
        return {'name': name, 'route': 'cuda', 'source': source,
                'replaces': replaces, 'launches': n, 'max_abs_err': err,
                'ms': ms, 'plain_ms': plain, 'bound_ms': bms,
                'bound_by': bby, 'library_ms': None}

    kernels = [
        entry('fused_projected_similarity_argmax',
              'yoloclip_tpu_torch/csrc/similarity.cu',
              'yoloclip_tpu/ops/pallas/similarity.py:240',
              ('similarity', torch.float32), launches['similarity'],
              sim_err),
        entry('nms_keep', 'yoloclip_tpu_torch/csrc/nms.cu',
              'yoloclip_tpu/ops/pallas/nms.py:103', ('nms', torch.float32),
              launches['nms'], nms_err),
        entry('fused_similarity_argmax',
              'yoloclip_tpu_torch/csrc/similarity.cu',
              'yoloclip_tpu/ops/pallas/similarity.py:110',
              ('unprojected', torch.float32),
              launches['similarity_unprojected'], k3_err),
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
