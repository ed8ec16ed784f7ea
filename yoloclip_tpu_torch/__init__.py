"""YOLO-CLIP in PyTorch with hand-written CUDA kernels for the NVIDIA H100.

A port of `yoloclip_tpu`'s open-vocabulary inference path: the CLIP text
tower turns class names or free-text prompts into a vocabulary, then
letterbox -> YOLOv8 backbone -> RepVL-PAN neck -> per-level contrastive
scoring -> DFL decode -> rescale -> top-k + class-agnostic greedy NMS.

The JAX package stays the reference; the tests feed both packages the same
weights (`utils/convert.py`) and the same inputs. Every Pallas TPU kernel
of the JAX package has a CUDA C++ counterpart under `csrc/`, built with
nvcc at first use (`_build.py`):

  * `ops/kernels/similarity.py` -- cosine max/argmax, two modes of
    `csrc/similarity.cu`: projection-folded (replaces `yoloclip_tpu/ops/
    pallas/similarity.py::fused_projected_similarity_argmax`) and
    unprojected (replaces `fused_similarity_argmax` of the same file);
  * `ops/kernels/nms.py` -- the exact greedy NMS keep mask (replaces
    `yoloclip_tpu/ops/pallas/nms.py::nms_keep_pallas`).

The W8A8 int8 deploy graph (`ops/quantize.py`) adds one kernel with no
Pallas twin: `ops/kernels/int8_conv.py` (`csrc/int8_conv.cu`), the
quantize -> s8 x s8 -> s32 conv -> dequant + bias + SiLU of an eligible
ConvBlock, which replaces the XLA int8 conv of the JAX package's ConvBlock.

Each kernel is a `torch.library` op (`ops/kernels/library.py`) whose cpu
implementation is the plain PyTorch version and whose cuda implementation
the kernel: a wrapper runs the plain version for CPU tensors only, and for
CUDA tensors launches the kernel or raises. Being ops, the kernels stay in
a `torch.export` artifact of the detector (`utils/export.py`).

This package imports torch and never jax, and nothing of the JAX package:
what it shares with it (the config dataclasses, the weight key map, the
tokenizer, the drawing helper) it keeps as its own copies.
"""

__version__ = "0.2.0"
