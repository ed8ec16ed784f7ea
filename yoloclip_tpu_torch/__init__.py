"""YOLO-CLIP in PyTorch with hand-written CUDA kernels for the NVIDIA H100.

A port of `yoloclip_tpu`'s batched open-vocabulary inference path:
letterbox -> YOLOv8 backbone -> RepVL-PAN neck -> per-level contrastive
scoring -> DFL decode -> rescale -> top-k + class-agnostic greedy NMS.

The JAX package stays the reference; the tests feed both packages the same
weights (`utils/convert.py::state_dict_from_jax`) and the same inputs.
Two Pallas TPU kernels on that path have CUDA C++ counterparts under
`csrc/`, built with nvcc at first use (`_build.py`):

  * `ops/kernels/similarity.py` -- projection-folded cosine max/argmax
    (replaces `yoloclip_tpu/ops/pallas/similarity.py::
    fused_projected_similarity_argmax`);
  * `ops/kernels/nms.py` -- the exact greedy NMS keep mask (replaces
    `yoloclip_tpu/ops/pallas/nms.py::nms_keep_pallas`).

Each kernel wrapper runs its plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.

This package imports torch and never jax. From the JAX package it uses only
the jax-free modules `yoloclip_tpu.config`, `yoloclip_tpu.utils.convert`
and `yoloclip_tpu.utils.visualize`.
"""

__version__ = "0.1.0"
