"""
Validation for 3-level r-RESPA bench defaults: NVE energy drift and
NVT throughput per (n_respa, rebuild_every, respa_mid) on the headline
9826-atom tungsten config (real accelerator, one session).

NVE drift criterion follows tests/test_device_potential.py (2e-4
eV/atom over the run); staleness must be False or the cadence is
rejected for bench defaults.  Throughput is the bench protocol
(launch_chunks=10 NVT windows) but with one 540-step window per
config to keep the sweep bounded.
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
                   "validate_respa_mid.json")


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    n = len(geom)
    results = {"n_atoms": n, "platform": jax.devices()[0].platform}
    if os.path.exists(OUT):   # merge into the existing sweep artifact
        with open(OUT) as f:
            results.update(json.load(f))

    configs = [tuple(int(x) for x in a.split(":"))
               for a in sys.argv[1:]] or \
        [(6, 24, 1), (6, 24, 2), (6, 24, 3), (6, 36, 2)]
    for n_respa, rb, mid in configs:
        key = f"respa{n_respa}_rb{rb}_mid{mid}"
        system = MDSystem(model, geom, dtype=jnp.float32,
                          rebuild_every=rb, skin=0.5, skin_2b=1.2,
                          capacity_2b=72, capacity_3b=16,
                          n_respa=n_respa, respa_mid=mid)
        state = system.init_state(temperature=300.0, seed=0)
        state = system.run(state, n_steps=rb * 7, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0)
        ek0 = float(system.kinetic_energy(state))
        e0 = float(state.energy) + ek0
        n_steps = rb * 28  # ~1.3-2 ps
        state = system.run(state, n_steps=n_steps, dt_fs=2.0)
        jax.block_until_ready(state.positions)
        e1 = float(state.energy) + float(system.kinetic_energy(state))
        drift = abs(e1 - e0) / n
        stale_nve = bool(state.stale)
        # throughput: bench protocol; warm the EXACT timed graph
        # (540-step launch_chunks window) before timing
        state = system.run(state, n_steps=540, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0,
                           launch_chunks=10, sync=False)
        jax.block_until_ready(state.positions)
        t0 = time.perf_counter()
        state = system.run(state, n_steps=540, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0,
                           launch_chunks=10, sync=False)
        jax.block_until_ready(state.positions)
        dt = time.perf_counter() - t0
        results[key] = {
            "nve_drift_eV_per_atom": round(drift, 8),
            "nve_steps": n_steps,
            "stale_nve": stale_nve,
            "stale": bool(state.stale),
            "overflow": bool(system.overflowed(state)),
            "atom_steps_per_s_nvt": round(n * 540 / dt, 1),
        }
        print(key, results[key], flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
