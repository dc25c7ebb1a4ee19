"""
Chunk-level RESPA timing on the real accelerator: sustained
atom-steps/s for n_respa in {1, 3, 4} at matched settings, plus
rebuild-cadence sensitivity.  Times run() at steady state (includes
rebuild amortization) -- the number the headline bench reports.
"""

import os
import sys
import time


import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501


def sustained(system, steps_per_chunk=90, chunks=6):
    state = system.init_state(temperature=300.0, seed=0)
    state = system.run(state, n_steps=126, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0,
                       on_overflow="warn")
    jax.block_until_ready(state.positions)
    n = state.positions.shape[0]
    t0 = time.perf_counter()
    for _ in range(chunks):
        state = system.run(state, n_steps=steps_per_chunk, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0,
                           on_overflow="warn")
    jax.block_until_ready(state.positions)
    dt = time.perf_counter() - t0
    total = chunks * steps_per_chunk * n
    return total / dt


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    for n_respa, rebuild in ((1, 18), (3, 18), (3, 24), (4, 24)):
        system = MDSystem(model, geom, dtype=jnp.float32,
                          rebuild_every=rebuild, skin=0.5,
                          skin_2b=1.2, capacity_2b=72,
                          capacity_3b=16, n_respa=n_respa)
        rate = sustained(system)
        print(f"n_respa={n_respa} rebuild={rebuild}: "
              f"{rate / 1e6:6.3f}e6 atom-steps/s")


if __name__ == "__main__":
    main()
