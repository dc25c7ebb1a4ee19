"""
Batched A/B throughput sweep for the MD engine: measures end-to-end
atom-steps/s for the variants under consideration in ONE GPU session
(compare variants only within one run, on one card).

Variants swept (each via MDSystem.run on the headline 9826-atom 2+3B
tungsten configuration, bench.py conditions):
  - n_respa in {1, 2, 3, 4}
  - rebuild_every in {12, 24, 36} at the best respa

Usage: python benchmarks/ab_sweep.py [quick]
  quick: 1 measured rep per variant instead of 2.
"""

import json
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


def measure(model, geom, n_respa, rebuild_every, n_steps=1008,
            reps=2):
    system = MDSystem(model, geom, dtype=jnp.float32,
                      rebuild_every=rebuild_every, skin=0.5,
                      skin_2b=1.2, capacity_2b=72, capacity_3b=16,
                      n_respa=n_respa)
    state = system.init_state(temperature=300.0, seed=0)
    state = system.run(state, n_steps=126, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0)
    # warm the measured chunk shape too
    state = system.run(state, n_steps=n_steps, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0)
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        state = system.run(state, n_steps=n_steps, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0)
        jax.block_until_ready(state.positions)
        rate = len(geom) * n_steps / (time.perf_counter() - t0)
        best = max(best, rate)
    assert not system.overflowed(state)
    return best


def main():
    require_gpu()
    enable_compile_cache()
    quick = len(sys.argv) > 1 and sys.argv[1] == "quick"
    reps = 1 if quick else 2
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    print(f"n_atoms = {len(geom)}, "
          f"platform = {jax.devices()[0].platform}", flush=True)
    results = {}
    for n_respa in (1, 2, 3, 4):
        rate = measure(model, geom, n_respa, 18, reps=reps)
        results[f"respa{n_respa}_rb18"] = rate
        print(f"n_respa={n_respa} rebuild=18: {rate:.3e} "
              f"atom-steps/s", flush=True)
    best_respa = max((1, 2, 3, 4),
                     key=lambda k: results[f"respa{k}_rb18"])
    for rb in (12, 24, 36):
        rate = measure(model, geom, best_respa, rb, reps=reps)
        results[f"respa{best_respa}_rb{rb}"] = rate
        print(f"n_respa={best_respa} rebuild={rb}: {rate:.3e} "
              f"atom-steps/s", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
