"""
Long-horizon NVE validation of the FINAL bench r-RESPA configuration:
5,184 steps (10.4 ps) of NVE after a 300 K Langevin equilibration,
with the total-energy trace recorded every 432 steps -- deep r-RESPA
cadences can hide slow resonance heating that a 648-step drift check
misses (the mid timestep approaches the phonon-stability edge).

Writes benchmarks_data/artifacts/validate_final.json.

Usage: python benchmarks/validate_final.py [n_respa respa_mid rebuild]
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501

OUT = os.path.join(REPO, "benchmarks_data", "artifacts",
                   "validate_final.json")


def main():
    require_gpu()
    enable_compile_cache()
    n_respa = int(sys.argv[1]) if len(sys.argv) > 1 else 18
    respa_mid = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    rebuild = int(sys.argv[3]) if len(sys.argv) > 3 else 36
    r_lo = float(sys.argv[4]) if len(sys.argv) > 4 else None
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    n = len(geom)
    system = MDSystem(model, geom, dtype=jnp.float32,
                      rebuild_every=rebuild, skin=0.5, skin_2b=1.2,
                      capacity_2b=72, capacity_3b=16,
                      n_respa=n_respa, respa_mid=respa_mid,
                      respa_switch=(None if r_lo is None
                                    else (r_lo, 3.5)))
    state = system.init_state(temperature=300.0, seed=0)
    state = system.run(state, n_steps=4 * rebuild, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0)
    e0 = float(state.energy) + system.kinetic_energy(state)
    trace = []
    block = 12 * rebuild
    for i in range(12):
        state = system.run(state, n_steps=block, dt_fs=2.0,
                           launch_chunks=4)
        e = float(state.energy) + system.kinetic_energy(state)
        trace.append(round((e - e0) / n, 9))
        print(f"step {(i + 1) * block}: drift {(e - e0) / n:.3e} "
              f"eV/atom", flush=True)
    assert not system.overflowed(state)
    drift = abs(trace[-1])
    # separate SECULAR heating (r-RESPA resonance: linear growth,
    # disqualifying) from the BOUNDED shadow-energy offset (constant
    # plateau, set by the outer step and the switch stiffness):
    # least-squares slope over the trace
    import numpy as _np
    idx = _np.arange(1, 13, dtype=float)
    slope = float(_np.polyfit(idx, _np.asarray(trace), 1)[0])
    secular = abs(slope) * 12
    amplitude = float(_np.max(_np.abs(trace)))
    result = {
        "config": {"n_atoms": n, "n_respa": n_respa,
                   "respa_mid": respa_mid, "rebuild_every": rebuild,
                   "respa_switch_r_lo": r_lo,
                   "platform": jax.devices()[0].platform},
        "n_steps": 12 * block,
        "drift_trace_ev_per_atom": trace,
        "final_drift_ev_per_atom": float(f"{drift:.3e}"),
        "secular_heating_ev_per_atom_over_run": float(
            f"{secular:.3e}"),
        "shadow_amplitude_ev_per_atom": float(f"{amplitude:.3e}"),
        "criterion": 2e-4,
        "passes": bool(drift <= 2e-4),
        "passes_secular": bool(secular <= 2e-4),
    }
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
