"""Training checkpoints as one torch file each. Counterpart of
`yoloclip_tpu/utils/checkpoint.py` (orbax directories there).

A checkpoint holds {'model': the model's state dict (parameters and
BatchNorm buffers, reference key layout), 'ema': the EMA of the parameters
or None, 'optimizer': the optimizer's state dict or None, 'step': int,
'metadata': dict}. It is written to a temporary file beside the target and
renamed over it, so a crash mid-save never leaves a torn checkpoint. Every
value loads under `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def _cpu(sd: Optional[Dict[str, torch.Tensor]]):
    if sd is None:
        return None
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(path: str, model_state: Dict[str, torch.Tensor],
                    ema: Optional[Dict[str, torch.Tensor]] = None,
                    optimizer_state: Optional[Dict[str, Any]] = None,
                    step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + '.tmp'
    torch.save({'model': _cpu(model_state), 'ema': _cpu(ema),
                'optimizer': optimizer_state, 'step': int(step),
                'metadata': dict(metadata or {})}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict `save_checkpoint` wrote, tensors on the CPU."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f'{path} is a directory: JAX orbax checkpoints are not read by '
            'the port. Convert it on a machine with JAX: python '
            f'tools/orbax_to_torch.py {path} model.pt (its EMA parameters '
            'when present), then load model.pt')
    return torch.load(path, map_location='cpu', weights_only=True)


def is_training_checkpoint(obj: Any) -> bool:
    return isinstance(obj, dict) and 'model' in obj and 'step' in obj
