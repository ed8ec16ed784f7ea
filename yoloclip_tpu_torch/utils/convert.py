"""Weights from the JAX package into the port.

flax variables -> `yoloclip_tpu.utils.convert.export_reference_state_dict`
(numpy only) -> a torch state dict in the reference key layout, which the
port's module tree loads with strict=True.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from yoloclip_tpu.config import ModelConfig
from yoloclip_tpu.utils.convert import export_reference_state_dict


def state_dict_from_jax(variables: Dict[str, Any],
                        cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """flax variables ({'params', 'batch_stats'}, arrays convertible with
    np.asarray) -> torch state dict. BatchNorm's `num_batches_tracked`
    counters, which flax does not keep, are set to 0."""
    sd = export_reference_state_dict(variables, cfg)
    out = {k: torch.from_numpy(np.array(v, dtype=np.float32))
           for k, v in sd.items()}
    for k in sd:
        if k.endswith('.bn.running_var'):
            out[k[:-len('running_var')] + 'num_batches_tracked'] = (
                torch.tensor(0, dtype=torch.long))
    return out
