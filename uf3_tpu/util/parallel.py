"""
Host task-pool helpers: scatter dataframe batches to a
concurrent.futures executor and gather/merge results.

This mirrors the reference's CPU backend (uf3/util/parallel.py, which
prefers dask.distributed when available).  The framework's primary
parallelism is device-side (uf3_tpu/parallel/mesh.py: shard_map over
a device mesh); this module exists for host-bound preprocessing.
"""

import sys
import time
from concurrent import futures as cf
from typing import Callable, List

import numpy as np
import pandas as pd


class ProgressText:
    """Timestamped text progress counter (tqdm-free)."""

    def __init__(self, iterable, total=None, frequency=10):
        self.iterable = iterable
        self.total = total if total is not None else len(iterable)
        self.frequency = frequency

    def __iter__(self):
        start = time.time()
        interval = max(1, self.total // self.frequency)
        for i, item in enumerate(self.iterable):
            if i % interval == 0:
                elapsed = time.time() - start
                print(f"[{elapsed:8.1f}s] {i}/{self.total}",
                      file=sys.stderr)
            yield item


def progress_iter(iterable, total=None, style=None):
    """Wrap an iterable with an optional progress indicator."""
    if style in (None, False, "none"):
        return iterable
    if style == "bar":
        try:
            from tqdm import tqdm
            return tqdm(iterable, total=total)
        except ImportError:
            pass
    return ProgressText(iterable, total=total)


def split_dataframe(df: pd.DataFrame, n_batches: int) -> List[pd.DataFrame]:
    n_batches = min(n_batches, max(1, len(df)))
    bounds = np.linspace(0, len(df), n_batches + 1).astype(int)
    return [df.iloc[bounds[i]:bounds[i + 1]] for i in range(n_batches)
            if bounds[i] < bounds[i + 1]]


def batch_submit(func: Callable, batches: List, client, **kwargs) -> List:
    """Submit one task per batch to a concurrent.futures-style executor."""
    return [client.submit(func, batch, **kwargs) for batch in batches]


def gather_and_merge(future_list: List, client=None, cancel: bool = False,
                     progress=None) -> pd.DataFrame:
    """Collect futures and merge dict/array/DataFrame results."""
    results = []
    for future in cf.as_completed(future_list):
        results.append(future.result())
    if not results:
        return pd.DataFrame()
    first = results[0]
    if isinstance(first, pd.DataFrame):
        return pd.concat(results)
    if isinstance(first, dict):
        merged = {}
        for result in results:
            merged.update(result)
        return merged
    return np.concatenate(results)


def get_executor(n_workers: int = 4):
    """Process-pool executor for featurization batches."""
    return cf.ProcessPoolExecutor(max_workers=n_workers)
