"""Multi-stream combiner: one training step consumes one batch per flow.

A copy of `mmada_tpu/data/combined.py` (the port imports nothing of the JAX
package); the same batches in the same order.

Equivalent of `lightning.CombinedLoader(iterables, mode='max_size_cycle')`
(training/train_mmada.py:32,389-396): every step yields a dict with one
batch from each named stream; shorter streams cycle until the longest
finishes an epoch (for infinite streams this is a plain zip).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Mapping


class CombinedLoader:
    def __init__(self, iterables: Mapping[str, Iterable], mode: str = "max_size_cycle"):
        if mode not in ("max_size_cycle", "min_size"):
            raise ValueError(f"unsupported mode: {mode}")
        self.iterables = dict(iterables)
        self.mode = mode

    def __iter__(self) -> Iterator[dict]:
        if self.mode == "min_size":
            iters = {k: iter(v) for k, v in self.iterables.items()}
            while True:
                try:
                    yield {k: next(it) for k, it in iters.items()}
                except StopIteration:
                    return

        # max_size_cycle: track which streams exhausted at least once;
        # stop when the longest finishes, cycling the others
        iters = {k: iter(v) for k, v in self.iterables.items()}
        exhausted = {k: False for k in iters}
        while True:
            batch = {}
            for k in list(iters):
                try:
                    batch[k] = next(iters[k])
                except StopIteration:
                    exhausted[k] = True
                    if all(exhausted.values()):
                        return
                    iters[k] = iter(self.iterables[k])
                    try:
                        batch[k] = next(iters[k])
                    except StopIteration:
                        return
            yield batch
