"""Weights from the JAX package's flax trees into the port.

The port's own copy of the declarative key map of
`yoloclip_tpu/utils/convert.py` (torch key <-> flax path per block), in
numpy only, so the port reads flax weights without importing the JAX
package:

  flax conv kernel (kH, kW, I, O)  -> torch conv weight (O, I, kH, kW)
  flax Dense kernel (in, out)      -> torch linear weight (out, in)
  params bn.scale / bn.bias        -> BatchNorm weight / bias
  batch_stats bn.mean / bn.var     -> BatchNorm running_mean / running_var
  MultiHeadAttention               -> the same packed in_proj layout

`state_dict_from_jax` gives the detector's state dict in the original
repo's module layout; `quant_state_dict_from_jax` the int8 deploy model's
from the JAX package's `quantize_variables` output; and
`text_state_dict_from_flax` the CLIP text tower's in the OpenAI layout.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from yoloclip_tpu_torch.config import ModelConfig


def _conv_block_entries(tp: str, fp: Tuple[str, ...]):
    """(torch_prefix, flax_path) pairs for a ConvBlock (conv+bn)."""
    return [
        (f'{tp}.conv.weight', ('params',) + fp + ('conv', 'kernel'), 'conv'),
        (f'{tp}.bn.weight', ('params',) + fp + ('bn', 'scale'), 'id'),
        (f'{tp}.bn.bias', ('params',) + fp + ('bn', 'bias'), 'id'),
        (f'{tp}.bn.running_mean', ('batch_stats',) + fp + ('bn', 'mean'), 'id'),
        (f'{tp}.bn.running_var', ('batch_stats',) + fp + ('bn', 'var'), 'id'),
    ]


def _conv2d_entries(tp: str, fp: Tuple[str, ...]):
    """Plain nn.Conv2d with bias <-> flax Conv {kernel, bias}."""
    return [
        (f'{tp}.weight', ('params',) + fp + ('kernel',), 'conv'),
        (f'{tp}.bias', ('params',) + fp + ('bias',), 'id'),
    ]


def _linear_entries(tp: str, fp: Tuple[str, ...]):
    return [
        (f'{tp}.weight', ('params',) + fp + ('kernel',), 'linear'),
        (f'{tp}.bias', ('params',) + fp + ('bias',), 'id'),
    ]


def _csp_entries(tp: str, fp: Tuple[str, ...], n_bottlenecks: int,
                 text_guided: bool = False):
    out = []
    for cv in ('cv1', 'cv2', 'cv3'):
        out += _conv_block_entries(f'{tp}.{cv}', fp + (cv,))
    for i in range(n_bottlenecks):
        for cv in ('cv1', 'cv2'):
            out += _conv_block_entries(f'{tp}.bottlenecks.{i}.{cv}',
                                       fp + (f'bottlenecks_{i}', cv))
    if text_guided:
        out += _linear_entries(f'{tp}.text_proj', fp + ('text_proj',))
    return out


def build_key_map(cfg: ModelConfig) -> List[Tuple[str, Tuple[str, ...], str]]:
    """Full (torch_key, flax_path, transform) table for the detector."""
    depths = cfg.backbone_depths()
    entries: List[Tuple[str, Tuple[str, ...], str]] = []

    B = ('backbone',)
    entries += _conv_block_entries('backbone.stem', B + ('stem',))
    for s, depth in zip(range(1, 5), depths):
        entries += _conv_block_entries(f'backbone.stage{s}.0',
                                       B + (f'stage{s}_conv',))
        entries += _csp_entries(f'backbone.stage{s}.1',
                                B + (f'stage{s}_csp',), depth)
    for cv in ('cv1', 'cv2'):
        entries += _conv_block_entries(f'backbone.stage4.2.{cv}',
                                       B + ('stage4_sppf', cv))

    N = ('neck',)
    for i in range(3):
        entries += _conv_block_entries(f'neck.lateral_convs.{i}',
                                       N + (f'lateral_convs_{i}',))
        entries += _conv_block_entries(f'neck.fpn_convs.{i}',
                                       N + (f'fpn_convs_{i}',))
        entries += _csp_entries(f'neck.text_csplayers.{i}',
                                N + (f'text_csplayers_{i}',),
                                cfg.neck_bottlenecks, text_guided=True)
    for i in range(2):
        entries += _conv_block_entries(f'neck.up_channels.{i}',
                                       N + (f'up_channels_{i}',))
        entries += _conv_block_entries(f'neck.downsample_convs.{i}',
                                       N + (f'downsample_convs_{i}',))
    ipa = N + ('image_pooling_attention',)
    for i in range(3):
        entries += _linear_entries(
            f'neck.image_pooling_attention.projections.{i}',
            ipa + (f'projections_{i}',))
    for k in ('in_proj_weight', 'in_proj_bias'):
        entries.append((f'neck.image_pooling_attention.mha.{k}',
                        ('params',) + ipa + ('mha', k), 'id'))
    entries.append(('neck.image_pooling_attention.mha.out_proj.weight',
                    ('params',) + ipa + ('mha', 'out_proj_weight'), 'id'))
    entries.append(('neck.image_pooling_attention.mha.out_proj.bias',
                    ('params',) + ipa + ('mha', 'out_proj_bias'), 'id'))

    for i in range(3):
        H = (f'contrastive_heads_{i}',)
        entries += _conv_block_entries(
            f'contrastive_heads.{i}.obj_embed_conv.0', H + ('obj_0',))
        entries += _conv_block_entries(
            f'contrastive_heads.{i}.obj_embed_conv.1', H + ('obj_1',))
        entries += _conv2d_entries(
            f'contrastive_heads.{i}.obj_embed_conv.2', H + ('obj_2',))
        entries += _conv_block_entries(
            f'contrastive_heads.{i}.box_conv.0', H + ('box_0',))
        entries += _conv_block_entries(
            f'contrastive_heads.{i}.box_conv.1', H + ('box_1',))
        entries += _conv2d_entries(
            f'contrastive_heads.{i}.box_conv.2', H + ('box_2',))
        BH = ('box_head',)
        entries += _conv_block_entries(f'box_head.box_convs.{i}.0',
                                       BH + (f'box_convs_{i}_0',))
        entries += _conv_block_entries(f'box_head.box_convs.{i}.1',
                                       BH + (f'box_convs_{i}_1',))
        entries += _conv2d_entries(f'box_head.box_convs.{i}.2',
                                   BH + (f'box_convs_{i}_2',))
    return entries


def _to_torch_layout(arr: np.ndarray, transform: str) -> np.ndarray:
    if transform == 'conv':
        return arr.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    if transform == 'linear':
        return arr.T
    return arr


def _get(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def state_dict_from_jax(variables: Dict[str, Any],
                        cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """flax variables ({'params', 'batch_stats'}, leaves convertible with
    np.asarray) -> torch state dict in the original repo's key layout.
    Keys whose flax path is absent (the aux box towers when they were
    never initialised) are left out. BatchNorm's `num_batches_tracked`
    counters, which flax does not keep, are set to 0."""
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, transform in build_key_map(cfg):
        try:
            arr = np.asarray(_get(variables, fpath))
        except KeyError:
            continue
        out[tkey] = _tensor(_to_torch_layout(arr, transform))
        if tkey.endswith('.bn.running_var'):
            out[tkey[:-len('running_var')] + 'num_batches_tracked'] = (
                torch.tensor(0, dtype=torch.long))
    return out


def quant_state_dict_from_jax(qvariables: Dict[str, Any],
                              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 deploy variables ({'params'} from
    `ops/quantize.py::quantize_variables`, no batch_stats) -> the state dict
    of the port's `YOLOCLIP(quant='int8')`. Each ConvBlock scope holds
    either {wq (k, k, I, O) int8, wscale, qbias, act_scale}, which become
    `wq` in the kernel's (O, k, k, I) layout and the fp32 scales, or the
    BN-folded {wf (k, k, I, O), fbias}, which become `wf` (O, I, k, k) and
    `fbias`; every other entry converts as in `state_dict_from_jax`."""
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, transform in build_key_map(cfg):
        if tkey.endswith(('.bn.weight', '.bn.bias', '.bn.running_mean',
                          '.bn.running_var')):
            continue
        if tkey.endswith('.conv.weight') and fpath[-2:] == ('conv',
                                                             'kernel'):
            try:
                node = _get(qvariables, fpath[:-2])
            except KeyError:
                continue
            tp = tkey[:-len('.conv.weight')]
            if 'wq' in node:
                wq = np.asarray(node['wq'], np.int8)
                out[f'{tp}.wq'] = torch.from_numpy(
                    np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
                for k in ('wscale', 'qbias', 'act_scale'):
                    out[f'{tp}.{k}'] = _tensor(node[k])
            else:
                out[f'{tp}.wf'] = _tensor(_to_torch_layout(
                    np.asarray(node['wf']), 'conv'))
                out[f'{tp}.fbias'] = _tensor(node['fbias'])
            continue
        try:
            arr = np.asarray(_get(qvariables, fpath))
        except KeyError:
            continue
        out[tkey] = _tensor(_to_torch_layout(arr, transform))
    return out


def text_state_dict_from_flax(params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX text tower's param tree (`CLIPTextTransformer` params,
    leaves convertible with np.asarray) -> the port's OpenAI-layout state
    dict. The inverse of `convert_openai_state_dict` in the JAX package:
    Dense kernels (in, out) go back to torch's (out, in)."""
    sd: Dict[str, torch.Tensor] = {
        'token_embedding.weight': _tensor(params['token_embedding']),
        'positional_embedding': _tensor(params['positional_embedding']),
        'text_projection': _tensor(params['text_projection']),
        'ln_final.weight': _tensor(params['ln_final']['scale']),
        'ln_final.bias': _tensor(params['ln_final']['bias']),
    }
    layers = sum(1 for k in params if k.startswith('resblocks_'))
    for i in range(layers):
        blk = params[f'resblocks_{i}']
        p = f'transformer.resblocks.{i}.'
        attn = blk['attn']
        sd.update({
            p + 'ln_1.weight': _tensor(blk['ln_1']['scale']),
            p + 'ln_1.bias': _tensor(blk['ln_1']['bias']),
            p + 'ln_2.weight': _tensor(blk['ln_2']['scale']),
            p + 'ln_2.bias': _tensor(blk['ln_2']['bias']),
            p + 'attn.in_proj_weight': _tensor(attn['in_proj_weight']),
            p + 'attn.in_proj_bias': _tensor(attn['in_proj_bias']),
            p + 'attn.out_proj.weight': _tensor(attn['out_proj_weight']),
            p + 'attn.out_proj.bias': _tensor(attn['out_proj_bias']),
            p + 'mlp.c_fc.weight': _tensor(np.asarray(blk['c_fc']['kernel']).T),
            p + 'mlp.c_fc.bias': _tensor(blk['c_fc']['bias']),
            p + 'mlp.c_proj.weight':
                _tensor(np.asarray(blk['c_proj']['kernel']).T),
            p + 'mlp.c_proj.bias': _tensor(blk['c_proj']['bias']),
        })
    return sd
