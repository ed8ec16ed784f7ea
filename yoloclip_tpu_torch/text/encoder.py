"""Frozen CLIP text encoder with a per-prompt embedding cache. Counterpart
of `yoloclip_tpu/text/encoder.py`.

  * The tower runs over a (N, 77) token batch on the encoder's device; a
    batch of new prompts is padded with its last row to the next power of
    two (`_bucket`), as the JAX encoder does to bound recompiles.
  * Each unique prompt is encoded once per encoder and kept on the device.
  * Output rows are L2-normalised with max(norm, 1e-12); for nested prompt
    lists each row is the mean of its prompts' rows, not renormalised.
  * The architecture follows the checkpoint's shapes (vocabulary, width,
    context, depth; heads = width / 64); with no checkpoint the tower is
    ViT-B/32 at full width with random weights from `seed`, and
    `quality_issues()` says so.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from yoloclip_tpu_torch.text.model import CLIPTextTransformer, init_text_weights
from yoloclip_tpu_torch.text.tokenizer import CLIPTokenizer, default_tokenizer
from yoloclip_tpu_torch.utils.convert import (
    flax_text_params_from_state_dict, text_state_dict_from_flax)


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class CLIPTextEncoder:
    def __init__(self,
                 model_name: str = 'ViT-B/32',
                 embed_dim: int = 512,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 checkpoint_path: Optional[str] = None,
                 tokenizer: Optional[CLIPTokenizer] = None,
                 seed: int = 0,
                 dtype: str = 'float32',
                 device: Union[str, torch.device] = 'cuda'):
        """state_dict: a text tower in the OpenAI key layout (e.g.
        `utils.convert.text_state_dict_from_flax`); checkpoint_path: a
        `.npz` in the JAX package's flat `a/b/c` layout or a torch
        `.pt`/`.pth` OpenAI state dict (only the text keys are read);
        neither = random init from `seed`. dtype: the compute dtype
        ('float32' | 'bfloat16'); outputs are fp32."""
        if model_name != 'ViT-B/32':
            raise ValueError(
                f'Only ViT-B/32 text tower is implemented (got {model_name})')
        self.embed_dim = embed_dim
        self.tokenizer = tokenizer or default_tokenizer()
        self.device = torch.device(device)
        if state_dict is None and checkpoint_path is not None:
            state_dict = load_text_tower_state_dict(checkpoint_path)
        self.random_init = state_dict is None
        if state_dict is None:
            model = CLIPTextTransformer(output_dim=embed_dim)
            init_text_weights(model, torch.Generator().manual_seed(seed))
        else:
            vocab_size, width = state_dict['token_embedding.weight'].shape
            out_dim = int(state_dict['text_projection'].shape[1])
            if out_dim != embed_dim:
                raise ValueError(
                    f'text checkpoint projects to {out_dim}-d but the '
                    f'model expects embed_dim={embed_dim}')
            layers = 0
            while f'transformer.resblocks.{layers}.ln_1.weight' in state_dict:
                layers += 1
            model = CLIPTextTransformer(
                vocab_size=int(vocab_size), width=int(width),
                context_length=int(state_dict['positional_embedding'].shape[0]),
                layers=layers, heads=max(int(width) // 64, 1),
                output_dim=embed_dim)
            wanted = model.state_dict().keys()
            model.load_state_dict({k: v for k, v in state_dict.items()
                                   if k in wanted}, strict=True)
        cdtype = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
        # frozen: no optimizer ever sees the tower
        self.model = model.to(device=self.device, dtype=cdtype).eval(
            ).requires_grad_(False)
        self._cache: Dict[str, torch.Tensor] = {}

    @torch.inference_mode()
    def encode_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """(N, 77) int -> (N, E) L2-normalised fp32 embeddings on the
        encoder's device."""
        feats = self.model(torch.as_tensor(tokens, dtype=torch.long,
                                           device=self.device))
        norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
        return feats / norm.clamp_min(1e-12)

    def _encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        missing = [p for p in prompts if p not in self._cache]
        if missing:
            tokens = self.tokenizer.tokenize(missing)
            n = tokens.shape[0]
            b = _bucket(n)
            if b != n:
                tokens = np.concatenate(
                    [tokens, np.tile(tokens[-1:], (b - n, 1))], axis=0)
            emb = self.encode_tokens(tokens)[:n]
            self._cache.update(zip(missing, emb))
        return torch.stack([self._cache[p] for p in prompts])

    def __call__(self, text_prompts: Union[Sequence[str],
                                           Sequence[Sequence[str]]]
                 ) -> torch.Tensor:
        """Flat list -> (N, E); nested lists -> (len, E), each row the mean
        of that sample's normalised prompt embeddings (not renormalised)."""
        if len(text_prompts) == 0:
            return torch.zeros((0, self.embed_dim), dtype=torch.float32,
                               device=self.device)
        if isinstance(text_prompts[0], (list, tuple)):
            return torch.stack([self._encode_prompts(list(p)).mean(dim=0)
                                for p in text_prompts])
        return self._encode_prompts(list(text_prompts))

    def encode_vocabulary(self, vocabulary: Sequence[str]) -> torch.Tensor:
        """The "a photo of a {}" template over each class name."""
        return self(['a photo of a ' + v for v in vocabulary])

    def trainable_params(self) -> Dict[str, torch.nn.Parameter]:
        """The tower's parameters by name. The tower is frozen (no
        optimizer sees it); a fine-tuning path would start from these."""
        return dict(self.model.named_parameters())

    def quality_issues(self) -> List[str]:
        """Degraded-quality conditions a serving stack must surface:
        embeddings from a random-init tower or a zero-merge tokenizer look
        structurally valid but carry no CLIP semantics."""
        issues = []
        if self.random_init:
            issues.append(
                'text tower is RANDOM-INIT (no CLIP weights): pass '
                'text_checkpoint= (.npz or an OpenAI .pt/.pth) or '
                'state_dict=')
        if getattr(self.tokenizer, 'degraded', False):
            issues.append(
                'tokenizer runs in zero-merge byte mode (no BPE table): '
                'set CLIP_BPE_PATH to bpe_simple_vocab_16e6.txt.gz or place '
                'it in ~/.cache/clip/')
        return issues


def load_text_tower_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A text-tower checkpoint -> OpenAI-layout state dict: `.npz` in the
    JAX package's flat `a/b/c` param layout, or a torch `.pt`/`.pth` state
    dict of a full CLIP model or its text tower (`visual.*` and other keys
    the tower lacks are not read)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f'{path} is a directory: JAX orbax text-tower checkpoints are '
            'not read by the port. Convert it on a machine with JAX: python '
            f'tools/orbax_to_torch.py --text {path} tower.pth')
    if path.endswith('.npz'):
        tree: Dict = {}
        with np.load(path, allow_pickle=False) as data:
            for flat_key in data.files:
                parts = flat_key.split('/')
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = data[flat_key]
        return text_state_dict_from_flax(tree)
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    return {k: v.detach().float() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def save_text_tower_params(tower: Union['CLIPTextEncoder', torch.nn.Module,
                                        Dict[str, torch.Tensor]],
                           path: str) -> None:
    """Write a text tower (an encoder, its `CLIPTextTransformer`, or an
    OpenAI-layout state dict) as the JAX package's `.npz`: its flax param
    tree flattened to `a/b/c` keys, fp32. `load_text_tower_state_dict`
    and the JAX package's `load_text_tower_params` read it back."""
    if isinstance(tower, CLIPTextEncoder):
        tower = tower.model
    sd = tower.state_dict() if isinstance(tower, torch.nn.Module) else tower
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Dict, prefix: str) -> None:
        for k, v in node.items():
            key = f'{prefix}/{k}' if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(flax_text_params_from_state_dict(sd), '')
    np.savez(path, **flat)
