"""Architecture plug-ins: one module an architecture, found by the name a
configuration file gives under `architecture` (`lib/arch.py::load`;
`yoloclip` where the key is absent). Each function takes the
configuration dict. A module exposes:

  reference(cfg)           the plain float32 model (`torch.nn.Module`,
                           built on the current default device); its
                           `forward(canvas (B, 3, H, W) in [0, 1],
                           text (C, E))` returns (boxes (B, A, 4), xyxy in
                           canvas pixels, anchors level by level in the
                           order of `strides`, row-major; scores (B, A, C)
                           on the scale the system thresholds with
                           `conf_threshold`)
  state_shapes(cfg)        every state-dict key of the layout that the
                           reference and the system both load, and its
                           shape
  seeded_state_dict(cfg, seed, device)
                           float32 weights for those keys from the seed:
                           the init kinds and any output-bias prior
                           (`lib/weights.py` has the helpers); its
                           BatchNorm statistics are then calibrated
                           through `reference`
  flops_per_image(cfg, classes, hw)
                           FLOPs of one image of size hw through
                           `reference` against `classes` text rows,
                           counted on the meta device
  model_fields             the fields of the system's `ModelConfig` that
                           the architecture needs from the configuration
                           file; the detector is not built where the
                           system lacks one
  control(det, frames)     switches the comparison's control on in the
                           built detector, given one batch of the cell's
                           frames

Plug-ins import nothing of the system under test.
"""
