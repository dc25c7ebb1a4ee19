"""
MD throughput vs system size on the current accelerator (single chip).

Runs the flagship 2+3-body tungsten potential (benchmarks_data/
model_2and3.json) at three bcc supercell sizes through the production
cell-list path with the bench defaults (bench.py: 3-level r-RESPA
9/3, rebuild_every=27, triangle trio kernel, eager 3B refilter,
launch_chunks=10) and records atom-steps/s per size in
benchmarks_data/artifacts/md_scaling.json.

Usage: python benchmarks/md_scaling.py [reps ...]   (default 17 25 34)
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501

OUT = os.path.join(REPO, "benchmarks_data", "artifacts",
                   "md_scaling.json")


def main(reps_list):
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    results = {"platform": jax.devices()[0].platform,
               "config": "bench defaults (respa 12/6/36, switch "
                         "(2.5, 3.5), eager refilter, "
                         "launch_chunks 10)",
               "sizes": []}
    for reps in reps_list:
        geom = bulk("W", "bcc", a=3.1652) * (reps, reps, reps)
        n = len(geom)
        system = MDSystem(model, geom, dtype=jnp.float32,
                          rebuild_every=36, skin=0.5, skin_2b=1.2,
                          capacity_2b=72, capacity_3b=16,
                          n_respa=12, respa_mid=6,
                          respa_switch=(2.5, 3.5))
        state = system.init_state(temperature=300.0, seed=0)
        state = system.run(state, n_steps=144, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0)
        jax.block_until_ready(state.positions)
        assert not system.overflowed(state)
        # warm the exact timed graph, then median of 3 windows
        state = system.run(state, n_steps=720, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0,
                           launch_chunks=10, sync=False)
        jax.block_until_ready(state.positions)
        times = []
        n_steps = 720
        for _ in range(3):
            t0 = time.time()
            state = system.run(state, n_steps=n_steps, dt_fs=2.0,
                               thermostat="langevin",
                               temperature=300.0,
                               launch_chunks=10, sync=False)
            jax.block_until_ready(state.positions)
            times.append(time.time() - t0)
        dt = sorted(times)[1]
        row = {"n_atoms": n,
               "atom_steps_per_s": round(n * n_steps / dt, 1),
               "ms_per_step": round(dt / n_steps * 1e3, 3),
               "overflow": bool(system.overflowed(state)),
               "stale": bool(state.stale)}
        results["sizes"].append(row)
        print(row, flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [17, 25, 34])
