"""
Single-GPU sweep at the 9,826-atom bench shape: the hoisted-role
triangle trio kernel, the 0.6 A 3-body skin (staleness margin), and
the 12/3/36 r-RESPA cadence --
each measured for NVT throughput, the stale flag over the timed
window, AND 648-step NVE drift (criterion 2e-4 eV/atom).

Writes benchmarks_data/artifacts/r5_sweep.json.
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
                   "r5_sweep.json")

VARIANTS = {
    "base_9_3_27": dict(rebuild_every=27, skin=0.5, n_respa=9,
                        respa_mid=3),
    "tri": dict(rebuild_every=27, skin=0.5, n_respa=9, respa_mid=3,
                trio_triangle=True),
    "skin6": dict(rebuild_every=27, skin=0.6, n_respa=9, respa_mid=3),
    "tri_skin6": dict(rebuild_every=27, skin=0.6, n_respa=9,
                      respa_mid=3, trio_triangle=True),
    "tri_skin6_12_3_36": dict(rebuild_every=36, skin=0.6, n_respa=12,
                              respa_mid=3, trio_triangle=True),
    "tri_skin6_12_4_36": dict(rebuild_every=36, skin=0.6, n_respa=12,
                              respa_mid=4, trio_triangle=True),
    # eager_refilter defaults True (staleness hardening); these pin
    # the full-layout eager configurations beside the triangle
    # variants above
    "eager_9_3_27": dict(rebuild_every=27, skin=0.5, n_respa=9,
                         respa_mid=3, eager_refilter=True),
    "margin_9_3_27": dict(rebuild_every=27, skin=0.5, n_respa=9,
                          respa_mid=3, eager_refilter=False),
    "eager_12_3_36": dict(rebuild_every=36, skin=0.5, n_respa=12,
                          respa_mid=3, eager_refilter=True),
    "eager_12_4_36": dict(rebuild_every=36, skin=0.5, n_respa=12,
                          respa_mid=4, eager_refilter=True),
    "eager_18_3_36": dict(rebuild_every=36, skin=0.5, n_respa=18,
                          respa_mid=3, eager_refilter=True),
    "eager_12_6_36": dict(rebuild_every=36, skin=0.5, n_respa=12,
                          respa_mid=6, eager_refilter=True),
    "eager_18_6_36": dict(rebuild_every=36, skin=0.5, n_respa=18,
                          respa_mid=6, eager_refilter=True),
    "eager_16_4_32": dict(rebuild_every=32, skin=0.5, n_respa=16,
                          respa_mid=4, eager_refilter=True),
    "eager_18_9_36": dict(rebuild_every=36, skin=0.5, n_respa=18,
                          respa_mid=9, eager_refilter=True),
    "eager_24_6_48": dict(rebuild_every=48, skin=0.5, n_respa=24,
                          respa_mid=6, eager_refilter=True),
    "eager_24_8_48": dict(rebuild_every=48, skin=0.5, n_respa=24,
                          respa_mid=8, eager_refilter=True),
    "eager_10_5_30": dict(rebuild_every=30, skin=0.5, n_respa=10,
                          respa_mid=5, eager_refilter=True),
    # wider C^2 switch band (2.5, 3.5): the V dS' term's stiffness
    # dominates the outer-level shadow energy, and a 1.0 A band
    # softens it against the (3.0, 3.5) default
    "eager_12_6_36_lo25": dict(rebuild_every=36, skin=0.5,
                               n_respa=12, respa_mid=6,
                               respa_switch=(2.5, 3.5),
                               eager_refilter=True),
    "eager_18_6_36_lo25": dict(rebuild_every=36, skin=0.5,
                               n_respa=18, respa_mid=6,
                               respa_switch=(2.5, 3.5),
                               eager_refilter=True),
    # -- blocked two-stage pack rebuild (the builder default) --
    # the shipped 12/6/36 cadence, then whether a wider 2-body skin
    # (rarer full rebuilds, costlier tail gather) or deeper launch
    # chunking pays
    "pack2_12_6_36": dict(rebuild_every=36, skin=0.5, n_respa=12,
                          respa_mid=6, respa_switch=(2.5, 3.5)),
    "pack2_sk16_c96": dict(rebuild_every=36, skin=0.5, n_respa=12,
                           respa_mid=6, respa_switch=(2.5, 3.5),
                           skin_2b=1.6, capacity_2b=96),
    "pack2_sk20_c112": dict(rebuild_every=36, skin=0.5, n_respa=12,
                            respa_mid=6, respa_switch=(2.5, 3.5),
                            skin_2b=2.0, capacity_2b=112),
    "pack2_lc20": dict(rebuild_every=36, skin=0.5, n_respa=12,
                       respa_mid=6, respa_switch=(2.5, 3.5),
                       launch_chunks=20),
    "pack2_rb72": dict(rebuild_every=72, skin=0.5, n_respa=12,
                       respa_mid=6, respa_switch=(2.5, 3.5),
                       skin_2b=1.6, capacity_2b=96),
    # static full rebuild every cycle: no adaptive trigger, no
    # lax.switch flush; every cycle starts with exact lists
    "pack2_static": dict(rebuild_every=36, skin=0.5, n_respa=12,
                         respa_mid=6, respa_switch=(2.5, 3.5),
                         static_rebuild=True),
    "pack2_static_lc20": dict(rebuild_every=36, skin=0.5, n_respa=12,
                              respa_mid=6, respa_switch=(2.5, 3.5),
                              static_rebuild=True, launch_chunks=20),
    # static rebuild needs the 2B skin to cover only ONE cycle's
    # drift: a tighter skin shrinks the capacity and the tail gather
    "pack2_static_sk08_c64": dict(rebuild_every=36, skin=0.5,
                                  n_respa=12, respa_mid=6,
                                  respa_switch=(2.5, 3.5),
                                  static_rebuild=True, skin_2b=0.8,
                                  capacity_2b=64),
}


def run_variant(model, geom, name, kw):
    n = len(geom)
    kw = dict(kw)
    launch_chunks = kw.pop("launch_chunks", 10)
    kw.setdefault("skin_2b", 1.2)
    kw.setdefault("capacity_2b", 72)
    system = MDSystem(model, geom, dtype=jnp.float32,
                      capacity_3b=16, **kw)
    # NVE drift: 648 steps from a 300 K start
    state = system.init_state(temperature=300.0, seed=0)
    state = system.run(state, n_steps=108, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0)
    e0 = float(state.energy) + system.kinetic_energy(state)
    state_nve = system.run(state, n_steps=648, dt_fs=2.0)
    drift = abs(float(state_nve.energy)
                + system.kinetic_energy(state_nve) - e0) / n
    # NVT throughput, bench protocol
    state = system.run(state, n_steps=540, dt_fs=2.0,
                       thermostat="langevin", temperature=300.0,
                       launch_chunks=launch_chunks, sync=False)
    jax.block_until_ready(state.positions)
    times = []
    stale = False
    for _ in range(3):
        t0 = time.perf_counter()
        state = system.run(state, n_steps=540, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0,
                           launch_chunks=launch_chunks, sync=False)
        jax.block_until_ready(state.positions)
        times.append(time.perf_counter() - t0)
        stale = stale or bool(state.stale)
    assert not system.overflowed(state), f"overflow in {name}"
    rate = n * 540 / sorted(times)[1]
    return {"atom_steps_per_s": round(rate, 1),
            "ms_per_step": round(sorted(times)[1] / 540 * 1e3, 4),
            "nve_drift_ev_per_atom_648": float(f"{drift:.3e}"),
            "stale_any_timed_window": stale}


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    names = sys.argv[1:] or list(VARIANTS)
    results = {"n_atoms": len(geom),
               "platform": jax.devices()[0].platform, "variants": {}}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results["variants"] = json.load(f).get("variants", {})
    for name in names:
        print(f"=== {name} ===", flush=True)
        results["variants"][name] = run_variant(
            model, geom, name, VARIANTS[name])
        print(results["variants"][name], flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
