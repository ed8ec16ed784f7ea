#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yoloclip_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc and the repository checkout; imports no JAX.
Phases, each printing its results; any failure exits non-zero:

  1. device   -- the card's name and power limit (nvidia-smi);
  2. build    -- compile both CUDA kernels from yoloclip_tpu_torch/csrc/;
  3. kernel 1 -- folded similarity max/argmax vs its plain PyTorch version
                 at the main-path shapes, fp32 (TF32 off) and bf16;
  4. kernel 2 -- greedy NMS keep mask vs its plain version, bit for bit;
  5. main path -- YOLOCLIPDetector at variant 'n', 640x640, COCO-80
                 vocabulary, random weights from a seed: detect_batch on 32
                 frames of 480x640 at conf 0.25 and -1.0, detect on one
                 frame; both kernels must have launched; outputs finite;
                 a bs=2 fp32 run on the card against the same run on CPU;
  6. timing   -- detect_batch images/s (fp32, bf16) and each kernel beside
                 its plain version (CUDA events, medians).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Kernel 1 against its plain version: both sum fp32 products of the same
# fp32/bf16 inputs, in different orders; cosines are O(0.1-1).
SIM_ATOL = 1e-5
# Card (cuDNN, TF32 off) against CPU for the whole model: conv algorithms
# differ; random-init boxes reach 1e4 px through exp(wh).
XDEV_SCORE_ATOL = 1e-4
XDEV_BOX_RTOL, XDEV_BOX_ATOL = 1e-4, 1e-2
XDEV_TIE_GAP = 1e-4

BATCH, LEVELS, HIDDEN, EMBED = 32, (6400, 1600, 400), 256, 512


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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
    _build.build_all()
    print(f'[build] both kernels built from {_build.CSRC} in '
          f'{time.time() - t:.2f} s')


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


def _write_vocab(path: str) -> None:
    from yoloclip_tpu.config import COCO_CLASS_NAMES
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
    from yoloclip_tpu.config import InferenceConfig
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
    return det, launches


def phase_cross_device(det, vocab_path, frames) -> None:
    """Pre-NMS outputs of a bs=2 fp32 run on the card vs on the CPU."""
    from yoloclip_tpu.config import InferenceConfig
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


def phase_timing(det, vocab_path, frames, sim, nms, card: str):
    import dataclasses

    from yoloclip_tpu.config import InferenceConfig
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
    print(f'[time] detect_batch bs={BATCH} 640px COCO-80 variant n, frames '
          f'480x640 uint8 already on the card, conf 0.25: '
          f'fp32 {fp32:.1f} img/s (peak {peak:.2f} GiB), '
          f'bf16 {bf16:.1f} img/s  [{card}]')

    g = torch.Generator(device='cuda').manual_seed(3)
    k_ms = {'similarity': 0.0, 'nms': 0.0}
    p_ms = {'similarity': 0.0, 'nms': 0.0}
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
        print(f'[time] similarity {str(dtype)[6:]} all three levels: kernel '
              f'{tot_k:.3f} ms, plain {tot_p:.3f} ms  [{card}]')
        if dtype == torch.float32:
            k_ms['similarity'], p_ms['similarity'] = tot_k, tot_p
    boxes = _nms_scene(g, BATCH, 1024)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device='cuda')
    k_ms['nms'] = cuda_ms(lambda: nms.nms_keep(boxes, valid, 0.45))
    p_ms['nms'] = cuda_ms(lambda: nms.nms_keep_plain(boxes, valid, 0.45),
                          iters=5)
    print(f'[time] nms keep B={BATCH} K=1024: kernel {k_ms["nms"]:.3f} ms, '
          f'plain {p_ms["nms"]:.3f} ms  [{card}]')
    return k_ms, p_ms, {'fp32_img_s': fp32, 'bf16_img_s': bf16}


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

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randint(0, 256, (BATCH, 480, 640, 3), dtype=np.uint8)).cuda()
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, 'coco80_vocab.json')
        _write_vocab(vocab_path)
        det, launches = phase_main_path(sim, nms, vocab_path, frames)
        phase_cross_device(det, vocab_path, frames)
        k_ms, p_ms, _ = phase_timing(det, vocab_path, frames, sim, nms, card)

    require(not any(m.split('.')[0] in ('jax', 'jaxlib', 'flax')
                    for m in sys.modules), 'the port imported JAX')
    kernels = [
        {'name': 'fused_projected_similarity_argmax', 'route': 'cuda',
         'source': 'yoloclip_tpu_torch/csrc/similarity.cu',
         'replaces': 'yoloclip_tpu/ops/pallas/similarity.py:238',
         'launches': launches['similarity'], 'max_abs_err': sim_err,
         'ms': k_ms['similarity'], 'plain_ms': p_ms['similarity']},
        {'name': 'nms_keep', 'route': 'cuda',
         'source': 'yoloclip_tpu_torch/csrc/nms.cu',
         'replaces': 'yoloclip_tpu/ops/pallas/nms.py:102',
         'launches': launches['nms'], 'max_abs_err': nms_err,
         'ms': k_ms['nms'], 'plain_ms': p_ms['nms']},
    ]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
