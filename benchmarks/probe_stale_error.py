"""
Force error of a STALE neighbor list, measured directly: freeze the
two-tier lists at x0, advance real bench-config NVT dynamics until
the max drift crosses the staleness threshold (0.5 x skin, the
MDState.stale trip line), and compare forces on the frozen lists
against forces on fresh lists at the same positions.

This bounds the physical meaning of `stale=True` on a launch: a
possibly-missed neighbor can only be a pair that crossed from
outside r_cut + skin to inside r_cut mid-cycle, which at these skins
means it sits within ~drift of the cutoff where the spline basis
(and hence V and dV/dr) vanishes smoothly.

Writes benchmarks_data/artifacts/probe_stale_error.json.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501

OUT = os.path.join(REPO, "benchmarks_data", "artifacts",
                   "probe_stale_error.json")


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    kw = dict(dtype=jnp.float32, rebuild_every=27, skin_2b=1.2,
              capacity_2b=72, capacity_3b=16, n_respa=9, respa_mid=3)
    skin = float(sys.argv[1]) if len(sys.argv) > 1 else 0.5
    system = MDSystem(model, geom, skin=skin, **kw)
    state = system.init_state(temperature=300.0, seed=0)
    state = system.run(state, n_steps=270, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0)
    jax.block_until_ready(state.positions)

    # freeze lists at x0 (fresh build), then advance real dynamics
    # (with its own healthy rebuilds) and evaluate the frozen lists
    # at increasing drift
    x0 = state.positions
    nbr2_0, nbr3_0 = system.build_lists(x0, state.cell, wrapped=False)
    stale_thresh = 0.5 * system.skin
    samples = []
    drift = 0.0
    # sample beyond 2x the single-atom stale line: covers the
    # top-2-sum criterion's worst realizable drift at the 36-step
    # production rebuild window
    while drift < 2.2 * stale_thresh and len(samples) < 30:
        state = system.run(state, n_steps=27, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0)
        x1 = state.positions
        drift = float(jnp.max(jnp.sqrt(jnp.sum(
            (x1 - x0) ** 2, axis=-1))))
        _, f_stale, _ = system.energy_forces(x1, nbr2_0, nbr3_0,
                                             cell=state.cell)
        nbr2_f, nbr3_f = system.build_lists(x1, state.cell,
                                            wrapped=False)
        _, f_fresh, _ = system.energy_forces(x1, nbr2_f, nbr3_f,
                                             cell=state.cell)
        err = float(jnp.max(jnp.abs(f_stale - f_fresh)))
        rms_f = float(jnp.sqrt(jnp.mean(f_fresh ** 2)))
        samples.append({"max_drift_A": round(drift, 4),
                        "past_stale_line": drift > stale_thresh,
                        "max_abs_force_error_eV_A": float(
                            f"{err:.3e}"),
                        "rms_force_eV_A": round(rms_f, 4)})
        print(samples[-1], flush=True)
    worst_stale = max((s["max_abs_force_error_eV_A"]
                       for s in samples if s["past_stale_line"]),
                      default=None)
    result = {
        "platform": jax.devices()[0].platform,
        "n_atoms": len(geom),
        "skin_3b": system.skin,
        "stale_threshold_A": stale_thresh,
        "samples": samples,
        "max_force_error_past_stale_line_eV_A": worst_stale,
        "interpretation": "frozen-list force error at drift just "
                          "past the stale trip line; compare to the "
                          "f32 device-force tolerance 2e-4 eV/A "
                          "(tests/test_gpu_numerics.py)",
    }
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "samples"}))


if __name__ == "__main__":
    main()
