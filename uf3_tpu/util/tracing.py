"""
Profiling and observability hooks (net-new vs the reference, which has
only print statements and tqdm bars; SURVEY.md section 5).

  * trace(): context manager around jax.profiler for device traces of
    the jitted step functions; profiler errors propagate.
  * Timer / report_timings: lightweight named wall-clock accumulation.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

_timings: Dict[str, list] = defaultdict(list)

# fixed default trace directory inside the checkout (git-ignored)
TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chiprun_out", "trace")


@contextlib.contextmanager
def trace(log_dir: str = TRACE_DIR):
    """Capture a jax.profiler device trace into ``log_dir``."""
    import jax
    jax.profiler.start_trace(log_dir)
    t0 = time.time()
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        _timings["trace"].append(time.time() - t0)


@contextlib.contextmanager
def timer(name: str, sync=None):
    """Accumulate wall-clock time under a name; pass a jax array (or
    pytree leaf) factory as ``sync`` to block on device completion."""
    t0 = time.time()
    try:
        yield
    finally:
        if sync is not None:
            import jax
            jax.block_until_ready(sync() if callable(sync) else sync)
        _timings[name].append(time.time() - t0)


def report_timings(reset: bool = True) -> Dict[str, Dict[str, float]]:
    """Summary statistics of accumulated timings."""
    import numpy as np
    summary = {}
    for name, values in _timings.items():
        arr = np.asarray(values)
        summary[name] = dict(count=len(arr), total=float(arr.sum()),
                             mean=float(arr.mean()),
                             min=float(arr.min()))
    if reset:
        _timings.clear()
    return summary


def annotate(name: str):
    """Named-scope annotation visible in device traces."""
    import jax
    return jax.named_scope(name)
