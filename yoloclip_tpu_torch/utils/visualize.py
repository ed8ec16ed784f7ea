"""Box and label drawing and the precision-recall plot. The port's copy of
`draw_detections` and `plot_precision_recall_curve` from
`yoloclip_tpu/utils/visualize.py`: an HSV colour wheel, cv2 when present,
else a pure-numpy rectangle outline; matplotlib, imported only by the plot
(not every machine has it)."""

from __future__ import annotations

import colorsys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def generate_colors(num_classes: int) -> List[Tuple[int, int, int]]:
    """Evenly spaced HSV wheel at s=0.8, v=0.8."""
    colors = []
    for i in range(num_classes):
        r, g, b = colorsys.hsv_to_rgb(i / max(num_classes, 1), 0.8, 0.8)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return colors


def draw_detections(image: np.ndarray, detections: Sequence[Dict],
                    num_classes: int = 80) -> np.ndarray:
    """Draw xyxy boxes and 'name: score' labels on a copy of `image`."""
    img = image.copy()
    colors = generate_colors(num_classes)
    try:
        import cv2
        for det in detections:
            x1, y1, x2, y2 = [int(v) for v in det['box']]
            color = colors[det['class_id'] % len(colors)]
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            label = f"{det['class_name']}: {det['score']:.2f}"
            (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX,
                                          0.5, 1)
            cv2.rectangle(img, (x1, y1 - th - 5), (x1 + tw, y1), color, -1)
            cv2.putText(img, label, (x1, y1 - 5), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (255, 255, 255), 1)
    except ImportError:
        for det in detections:
            x1, y1, x2, y2 = [int(v) for v in det['box']]
            color = colors[det['class_id'] % len(colors)]
            h, w = img.shape[:2]
            x1, x2 = np.clip([x1, x2], 0, w - 1)
            y1, y2 = np.clip([y1, y2], 0, h - 1)
            img[y1:y2 + 1, [x1, x2]] = color
            img[[y1, y2], x1:x2 + 1] = color
    return img


def plot_precision_recall_curve(precisions: np.ndarray, recalls: np.ndarray,
                                class_name: str = '',
                                save_path: Optional[str] = None):
    """The PR curve as a matplotlib figure (Agg backend), saved to
    save_path (and closed) when given."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(recalls, precisions)
    ax.set_xlabel('Recall')
    ax.set_ylabel('Precision')
    ax.set_title(f'PR curve {class_name}'.strip())
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    if save_path:
        fig.savefig(save_path, bbox_inches='tight')
        plt.close(fig)
    return fig
