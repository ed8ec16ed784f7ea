"""Convert a JAX orbax checkpoint directory into a torch file the PyTorch
port loads.

The port imports no JAX, so it cannot read orbax directories; this script
runs on a machine that has JAX, orbax, torch and both packages:

    python tools/orbax_to_torch.py run/final_model model.pt
    python tools/orbax_to_torch.py --text tower_dir tower.pth

A detector or training directory (`yoloclip_tpu.utils.checkpoint.
save_checkpoint`) is read with the JAX package's `load_checkpoint`; its
`ema_params` are taken when present, over `params`, as the JAX detector
serves them, with the BatchNorm statistics beside them. The variables go
through the port's key map (`yoloclip_tpu_torch.utils.convert.
state_dict_from_jax`) to the reference-layout state dict, which `torch.save`
writes; the port's detector takes the file as `model_path` (`--model` in
its CLIs). --text converts a text-tower directory
(`yoloclip_tpu.text.encoder.load_text_tower_params`) through
`text_state_dict_from_flax` to the OpenAI-layout state dict that the
port's `text_checkpoint` reads.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def convert_detector(src: str, cfg) -> dict:
    """An orbax detector or training directory -> the port's state dict."""
    from yoloclip_tpu.utils.checkpoint import load_checkpoint
    from yoloclip_tpu_torch.utils.convert import state_dict_from_jax
    v = load_checkpoint(src)['variables']
    variables = {
        'params': v['ema_params'] if v.get('ema_params') is not None
        else v['params'],
        'batch_stats': v.get('batch_stats', {}),
    }
    return state_dict_from_jax(variables, cfg)


def convert_text(src: str) -> dict:
    """An orbax text-tower directory -> the OpenAI-layout state dict."""
    from yoloclip_tpu.text.encoder import load_text_tower_params
    from yoloclip_tpu_torch.utils.convert import text_state_dict_from_flax
    import jax
    params = jax.tree_util.tree_map(np.asarray, load_text_tower_params(src))
    return text_state_dict_from_flax(params)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('src', help='orbax checkpoint directory')
    ap.add_argument('dst', help='torch file to write (.pt/.pth)')
    ap.add_argument('--text', action='store_true',
                    help='src is a text-tower directory')
    ap.add_argument('--config', default=None,
                    help='YAML config of the detector (its architecture)')
    ap.add_argument('--backbone', default=None, help='variant n/s/m/l/x')
    args = ap.parse_args(argv)
    if args.text:
        sd = convert_text(args.src)
    else:
        import dataclasses

        from yoloclip_tpu_torch.config import InferenceConfig, load_config
        cfg = load_config(InferenceConfig, args.config).model
        if args.backbone:
            cfg = dataclasses.replace(cfg, backbone_variant=args.backbone)
        sd = convert_detector(args.src, cfg)
    torch.save(sd, args.dst)
    print(f'{args.src} -> {args.dst}: {len(sd)} tensors')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
