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

Reference torch checkpoints need no key map (the port's keys and its text
tower's are the reference's): `load_reference_checkpoint` unwraps a
trainer checkpoint's `model_state_dict` and splits off the CLIP tower
(`extract_text_tower`), as the JAX package's functions of those names do.
JAX orbax directories convert on a machine with JAX through
`tools/orbax_to_torch.py`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

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


def flax_text_params_from_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `text_state_dict_from_flax`: an OpenAI-layout text
    tower -> the JAX text tower's param tree of fp32 numpy arrays (the
    layout of the JAX package's `convert_openai_state_dict`)."""
    def a(key):
        return torch.as_tensor(sd[key]).detach().cpu().float().numpy()

    params: Dict[str, Any] = {
        'token_embedding': a('token_embedding.weight'),
        'positional_embedding': a('positional_embedding'),
        'text_projection': a('text_projection'),
        'ln_final': {'scale': a('ln_final.weight'),
                     'bias': a('ln_final.bias')},
    }
    i = 0
    while f'transformer.resblocks.{i}.ln_1.weight' in sd:
        p = f'transformer.resblocks.{i}.'
        params[f'resblocks_{i}'] = {
            'ln_1': {'scale': a(p + 'ln_1.weight'),
                     'bias': a(p + 'ln_1.bias')},
            'ln_2': {'scale': a(p + 'ln_2.weight'),
                     'bias': a(p + 'ln_2.bias')},
            'attn': {
                'in_proj_weight': a(p + 'attn.in_proj_weight'),
                'in_proj_bias': a(p + 'attn.in_proj_bias'),
                'out_proj_weight': a(p + 'attn.out_proj.weight'),
                'out_proj_bias': a(p + 'attn.out_proj.bias'),
            },
            'c_fc': {'kernel': a(p + 'mlp.c_fc.weight').T,
                     'bias': a(p + 'mlp.c_fc.bias')},
            'c_proj': {'kernel': a(p + 'mlp.c_proj.weight').T,
                       'bias': a(p + 'mlp.c_proj.bias')},
        }
        i += 1
    return params


TEXT_PREFIX = 'text_encoder.clip_model.'


def extract_text_tower(state_dict: Dict[str, Any],
                       prefix: str = TEXT_PREFIX) -> Dict[str, torch.Tensor]:
    """The CLIP text tower of a reference checkpoint (the full CLIP model
    under `text_encoder.clip_model.*`) -> its OpenAI-layout state dict,
    fp32: the tower's keys with the prefix stripped (`visual.*` and the
    other keys of a full CLIP model are not read). Raises KeyError when the
    prefix holds no text tower, as the JAX package's function does."""
    sub = {k[len(prefix):]: v for k, v in state_dict.items()
           if k.startswith(prefix)}
    if 'transformer.resblocks.0.ln_1.weight' not in sub:
        raise KeyError(f'no {prefix}transformer.resblocks.*.ln_1.weight '
                       'keys: not a CLIP text tower')
    keep = ('token_embedding.', 'positional_embedding', 'text_projection',
            'ln_final.', 'transformer.resblocks.')
    return {k: torch.as_tensor(v).detach().float() for k, v in sub.items()
            if k.startswith(keep)}


def load_reference_checkpoint(path: str, cfg: ModelConfig
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         Optional[Dict[str, torch.Tensor]]]:
    """A reference torch `.pth` (a trainer checkpoint holding
    `model_state_dict`, or a bare state dict) -> (the detector's state
    dict, its text tower's OpenAI-layout state dict or None).

    The detector keys are those of `build_key_map(cfg)` that the file holds
    (the auxiliary box towers only when present), floats in fp32, with
    BatchNorm's `num_batches_tracked` set to 0 where the file has none;
    every other key (the text encoder among them) is not read, as in the
    JAX package. Loaded with `weights_only=True`: a reference
    trainer checkpoint (model, AdamW and OneCycleLR state dicts, epoch)
    holds only tensors and plain containers."""
    return reference_state_dicts(
        torch.load(path, map_location='cpu', weights_only=True), cfg)


def is_reference_checkpoint(obj: Any) -> bool:
    """A reference trainer checkpoint, or a state dict carrying the
    reference's text encoder."""
    return isinstance(obj, dict) and ('model_state_dict' in obj or any(
        isinstance(k, str) and k.startswith('text_encoder.') for k in obj))


def reference_state_dicts(ckpt: Any, cfg: ModelConfig
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Optional[Dict[str, torch.Tensor]]]:
    """`load_reference_checkpoint` on an already loaded object."""
    sd = ckpt.get('model_state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    out: Dict[str, torch.Tensor] = {}
    for tkey, _, _ in build_key_map(cfg):
        if tkey not in sd:
            if '.box_conv.' in tkey:
                continue
            raise KeyError(f'missing reference key: {tkey}')
        out[tkey] = torch.as_tensor(sd[tkey]).detach().float()
        if tkey.endswith('.bn.running_var'):
            nbt = tkey[:-len('running_var')] + 'num_batches_tracked'
            out[nbt] = torch.as_tensor(
                sd.get(nbt, torch.tensor(0))).to(torch.long)
    text = None
    if any(k.startswith(TEXT_PREFIX) for k in sd):
        try:
            text = extract_text_tower(sd)
        except KeyError:
            text = None
    return out, text
