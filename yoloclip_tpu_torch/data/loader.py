"""Batch collation and a threaded prefetching loader. The port's copy of
`yoloclip_tpu/data/loader.py`: the same batches in the same order for a
seed.

Batches come out NHWC float32 with every array fixed-shape (max_objects
padding) and `text_prompts` a list of lists; a worker thread pool overlaps
host decode/augment with device compute (cv2/PIL release the GIL).
`device_prefetch` keeps batches resident on the device ahead of the train
loop, uploaded from pinned memory without blocking the host.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List

import numpy as np
import torch


def collate(items: List[Dict]) -> Dict:
    """Stack fixed-shape arrays; keep text_prompts ragged (list of lists)."""
    batch = {
        'images': np.stack([it['images'] for it in items]),
        'boxes': np.stack([it['boxes'] for it in items]),
        'class_ids': np.stack([it['class_ids'] for it in items]),
        'valid_mask': np.stack([it['valid_mask'] for it in items]),
        'text_prompts': [it['text_prompts'] for it in items],
        'image_id': np.asarray([it['image_id'] for it in items]),
        'orig_size': [it['orig_size'] for it in items],
    }
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches_of_indices(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        out = []
        for i in range(0, len(idx), self.batch_size):
            b = idx[i:i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                continue
            out.append(b)
        return out

    def __iter__(self) -> Iterator[Dict]:
        batches = self._batches_of_indices()
        self._epoch += 1
        if self.num_workers == 0:
            for b in batches:
                yield collate([self.dataset[i] for i in b])
            return

        q: 'queue.Queue' = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()

        def worker(batch_indices, slot_q):
            for pos, b in batch_indices:
                if stop.is_set():
                    return
                try:
                    slot_q.put((pos, collate([self.dataset[i] for i in b])))
                except Exception as e:   # surface dataset errors to consumer
                    slot_q.put((pos, e))

        assignments = [[] for _ in range(self.num_workers)]
        for pos, b in enumerate(batches):
            assignments[pos % self.num_workers].append((pos, b))
        threads = [threading.Thread(target=worker, args=(a, q), daemon=True)
                   for a in assignments if a]
        for t in threads:
            t.start()

        pending: Dict[int, Dict] = {}
        next_pos = 0
        try:
            while next_pos < len(batches):
                while next_pos not in pending:
                    pos, item = q.get()
                    pending[pos] = item
                item = pending.pop(next_pos)
                if isinstance(item, Exception):
                    raise item
                yield item
                next_pos += 1
        finally:
            stop.set()


def device_prefetch(iterator: Iterator[Dict], device, size: int = 2
                    ) -> Iterator[Dict]:
    """Keep `size` batches ahead on `device`. Numeric numpy arrays become
    tensors there, copied from pinned host memory with non_blocking=True
    (a plain copy on the CPU); lists and other values pass through."""
    device = torch.device(device)
    pin = device.type == 'cuda'

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                t = torch.from_numpy(np.ascontiguousarray(v))
                if pin:
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=pin)
            else:
                out[k] = v
        return out

    buf: List[Dict] = []
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > size:
            yield buf.pop(0)
    yield from buf
