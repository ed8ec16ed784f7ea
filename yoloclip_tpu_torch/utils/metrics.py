"""COCO results export. The port's copies of `detections_to_coco_results`
and `save_coco_results` from `yoloclip_tpu/utils/metrics.py`; the mAP
evaluators come with the evaluation slice.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


def detections_to_coco_results(detections: Sequence[Dict], image_id: int,
                               category_ids: Optional[Dict[int, int]] = None
                               ) -> List[Dict]:
    """detect() output -> standard COCO results entries
    `[{image_id, category_id, bbox [x, y, w, h], score}]`.

    `category_ids` maps the model's contiguous class_id to the dataset's
    (possibly sparse) category id; identity when omitted.
    """
    out = []
    for d in detections:
        x1, y1, x2, y2 = (float(v) for v in d['box'])
        cid = int(d['class_id'])
        out.append({
            'image_id': int(image_id),
            'category_id': (category_ids[cid] if category_ids is not None
                            else cid),
            'bbox': [x1, y1, x2 - x1, y2 - y1],
            'score': float(d['score']),
        })
    return out


def save_coco_results(path: str, results: Sequence[Dict]) -> None:
    """Write a COCO results JSON (atomic rename)."""
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(list(results), f)
    os.replace(tmp, path)
