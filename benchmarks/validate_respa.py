"""
Validation of bench cadences: NVE energy drift per
r-RESPA depth and skin-staleness at longer rebuild cadences, on the
headline 9826-atom tungsten config (one GPU, one session).

NVE drift criterion follows tests/test_device_potential.py (2e-4
eV/atom over the run); staleness must be False or the cadence is
rejected for bench defaults.
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


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    n = len(geom)
    results = {"n_atoms": n, "platform": jax.devices()[0].platform}

    for n_respa, rb in ((3, 18), (4, 24), (6, 24), (6, 36)):
        system = MDSystem(model, geom, dtype=jnp.float32,
                          rebuild_every=rb, skin=0.5, skin_2b=1.2,
                          capacity_2b=72, capacity_3b=16,
                          n_respa=n_respa)
        state = system.init_state(temperature=300.0, seed=0)
        # thermalize with Langevin, then measure NVE drift
        state = system.run(state, n_steps=rb * 7, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0)
        ek0 = float(system.kinetic_energy(state))
        e0 = float(state.energy) + ek0
        n_steps = rb * 28  # ~1-2 ps
        t0 = time.perf_counter()
        state = system.run(state, n_steps=n_steps, dt_fs=2.0)
        jax.block_until_ready(state.positions)
        dt = time.perf_counter() - t0
        e1 = float(state.energy) + float(system.kinetic_energy(state))
        drift = abs(e1 - e0) / n
        results[f"respa{n_respa}_rb{rb}"] = {
            "nve_drift_eV_per_atom": round(drift, 8),
            "nve_steps": n_steps,
            "stale": bool(state.stale),
            "overflow": bool(system.overflowed(state)),
            "atom_steps_per_s_nve": round(n * n_steps / dt, 1),
        }
        print(f"respa{n_respa}_rb{rb}: drift {drift:.2e} eV/atom, "
              f"stale={bool(state.stale)}", flush=True)

    out_dir = os.path.join(REPO, "benchmarks_data", "artifacts")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "validate_respa.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
