"""
Multi-device demo: mesh-sharded training + halo-exchange MD, runnable
anywhere — with UF3_REAL_MESH=1 it uses the GPUs the process sees; by
default it forces an 8-device virtual CPU mesh, so the identical
sharded program can be exercised (and is: tests/test_parallel.py,
tests/test_halo.py pin these paths) without hardware.

Usage: python examples/multichip_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# default: an 8-device virtual CPU mesh (must be configured before
# jax initializes its backend).  Set UF3_REAL_MESH=1 to use whatever
# real devices the process sees instead (e.g. four GPUs).
if os.environ.get("UF3_REAL_MESH") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from uf3_tpu.data.atoms import bulk
from uf3_tpu.forcefield.md import MDSystem
from uf3_tpu.parallel import halo
from uf3_tpu.parallel import mesh as pmesh
from uf3_tpu.regression import least_squares as ls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    mesh = pmesh.make_mesh()
    n_dev = mesh.devices.size
    print(f"mesh: {n_dev} x {mesh.devices.flat[0].platform}")

    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))

    # ---- halo-exchange MD over the mesh -----------------------------
    geom = bulk("W", "bcc", a=3.1652) * (4, 4, 4 * n_dev)
    geom.rattle(0.03, seed=0)
    print(f"{len(geom)} atoms in {n_dev} slabs")
    system = MDSystem(model, geom, dtype=jnp.float64)
    dec = halo.decompose(
        np.asarray(geom.get_positions()), np.asarray(geom.get_cell()),
        n_shards=n_dev, r_cut_2b=system.r_cut_2b,
        r_cut_3b=system.r_cut_3b, skin=system.skin,
        capacity_2b=system.capacity_2b,
        capacity_3b=system.capacity_3b,
        masses=np.asarray(geom.get_masses()))
    chunk, shard = halo.halo_md_step_factory(system, mesh, n_steps=5)
    dec_dev = shard(dec)
    v0 = shard(np.zeros(dec.x_own.shape))
    dt = jnp.asarray(0.5 * 0.09822694788464063, dtype=jnp.float64)
    x_own, v, f, energy, stale = chunk(dec_dev, dec_dev.x_own, v0, dt)
    assert not bool(stale)  # within the Verlet skin: lists still valid
    print(f"halo MD: 5 NVE steps, E = {float(energy):.6f} eV "
          f"(collectives carry only the slab boundaries)")

    # cross-check: the same 5 NVE steps on the single-device engine
    state = system.init_state()
    state = system.run(state, n_steps=5,
                       dt_fs=float(dt / 0.09822694788464063))
    e_ref = float(state.energy)
    print(f"single-device E after the same steps: {e_ref:.6f} eV "
          f"(diff {abs(e_ref - float(energy)):.2e})")

    # ---- mesh-sharded training (device featurization + psum Gram) ---
    from uf3_tpu.data.composition import ChemicalSystem
    from uf3_tpu.ops.featurize_jax import featurize_dataset_device
    from uf3_tpu.representation.basis import BSplineBasis

    chemistry = ChemicalSystem(["W"], degree=3)
    basis = BSplineBasis(
        chemistry,
        r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5, 1.5, 1.5]},
        r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
        resolution_map={("W", "W"): 15, ("W", "W", "W"): [4, 4, 8]})
    rng = np.random.RandomState(0)
    geometries, energies, forces = [], [], []
    for i in range(8):
        g = bulk("W", "bcc", a=3.1652) * 2
        g.rattle(0.04, seed=i)
        geometries.append(g)
        energies.append(-11.0 * len(g) + rng.normal() * 0.2)
        forces.append(rng.normal(size=(3, len(g))) * 0.3)
    x_e, y_e, x_f, y_f = featurize_dataset_device(
        basis, geometries, energies, forces)
    fit_model = ls.WeightedLinearModel(basis, r2=1e-6, c2=1e-6,
                                       r3=1e-6, c3=1e-6)
    pmesh.fit_sharded(fit_model, np.asarray(x_e), np.asarray(y_e),
                      np.asarray(x_f), np.asarray(y_f), weight=0.5,
                      mesh=mesh)
    pred = np.asarray(x_e) @ fit_model.coefficients
    rmse = float(np.sqrt(np.mean((pred - np.asarray(y_e)) ** 2)))
    print(f"sharded fit: {len(geometries)} configs, per-atom-energy "
          f"RMSE {rmse * 1e3:.2f} meV (Gram psum over the mesh)")


if __name__ == "__main__":
    main()
