"""Vocabulary builder: prompt-template expansion over the text encoder.
Counterpart of `yoloclip_tpu/text/vocab.py`.

  * build_online_vocabulary: encode every template x class, mean over the
    templates, renormalise -> (num_classes, E) on the encoder's device.
  * build_offline_vocabulary: the same, kept as {class: (E,) float32} and
    optionally saved as JSON {class: [E floats]}.
  * load_offline_vocabulary: JSON -> {class: float32 array}, file order.
  * get_vocabulary_matrix: per-class lookup, encoding missing classes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from yoloclip_tpu_torch.text.encoder import CLIPTextEncoder

DEFAULT_TEMPLATES = [
    'a photo of a {}',
    'a photograph of a {}',
    'an image of a {}',
    'a picture of a {}',
    '{}',
]


class VocabularyBuilder:
    def __init__(self, text_encoder: CLIPTextEncoder,
                 prompt_templates: Optional[Sequence[str]] = None):
        self.text_encoder = text_encoder
        self.prompt_templates = list(prompt_templates or DEFAULT_TEMPLATES)
        self.offline_vocab: Dict[str, np.ndarray] = {}

    def build_online_vocabulary(self, class_names: Sequence[str]
                                ) -> torch.Tensor:
        """(num_classes, E) fp32: template-averaged, renormalised."""
        prompts = [t.format(name) for name in class_names
                   for t in self.prompt_templates]
        emb = self.text_encoder(prompts)
        emb = emb.reshape(len(class_names), len(self.prompt_templates),
                          -1).mean(dim=1)
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb / norm.clamp_min(1e-12)

    def build_offline_vocabulary(self, class_names: Sequence[str],
                                 save_path: Optional[str] = None
                                 ) -> Dict[str, np.ndarray]:
        emb = self.build_online_vocabulary(class_names).cpu().numpy()
        vocab = {name: emb[i] for i, name in enumerate(class_names)}
        if save_path is not None:
            d = os.path.dirname(save_path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(save_path, 'w') as f:
                json.dump({k: v.tolist() for k, v in vocab.items()}, f)
        self.offline_vocab = vocab
        return vocab

    def load_offline_vocabulary(self, path: str) -> Dict[str, np.ndarray]:
        with open(path) as f:
            raw = json.load(f)
        self.offline_vocab = {k: np.asarray(v, np.float32)
                              for k, v in raw.items()}
        return self.offline_vocab

    def get_vocabulary_matrix(self,
                              class_names: Optional[Sequence[str]] = None
                              ) -> torch.Tensor:
        """(len(class_names), E) fp32 on the encoder's device; every class
        of the offline vocabulary when class_names is None."""
        if class_names is None:
            class_names = list(self.offline_vocab.keys())
        if not self.offline_vocab:
            self.build_offline_vocabulary(class_names)
        missing = [n for n in class_names if n not in self.offline_vocab]
        if missing:
            emb = self.build_online_vocabulary(missing).cpu().numpy()
            self.offline_vocab.update(zip(missing, emb))
        rows = np.stack([self.offline_vocab[n] for n in class_names])
        return torch.from_numpy(rows).to(self.text_encoder.device)
