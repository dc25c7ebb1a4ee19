"""
Probe: which launches trip the staleness flag during NVT at the bench
config, and how large the per-cycle drift actually is.  The adaptive
boundary refresh triggers at half the stale threshold, so a genuine
trip requires >0.125 A of drift inside one 24-step cycle -- far
beyond ballistic motion at 300 K.  This pins down whether an NVT
stale=True flag is a real margin issue or a flag artifact.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501

OUT = os.path.join(REPO, "benchmarks_data", "artifacts",
                   "probe_stale.json")


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    system = MDSystem(model, geom, dtype=jnp.float32,
                      rebuild_every=24, skin=0.5, skin_2b=1.2,
                      capacity_2b=72, capacity_3b=16,
                      n_respa=6, respa_mid=3)
    state = system.init_state(temperature=300.0, seed=0)
    state = system.run(state, n_steps=126, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0)
    results = {"per_launch": []}
    for i in range(20):
        state = system.run(state, n_steps=24, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0)
        d3 = np.asarray(state.positions
                        - state.nbr3.reference_positions)
        d2 = np.asarray(state.positions
                        - state.nbr2.reference_positions)
        row = {"stale": bool(state.stale),
               "max_drift3": round(float(
                   np.sqrt((d3 * d3).sum(axis=1).max())), 4),
               "max_drift2": round(float(
                   np.sqrt((d2 * d2).sum(axis=1).max())), 4)}
        results["per_launch"].append(row)
        print(i, row, flush=True)
    print(json.dumps(results))
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
