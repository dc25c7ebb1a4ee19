"""
Device-featurization throughput benchmark: seconds per configuration
for flagship-fit-shaped work (128-atom rattled bcc tungsten cells,
2+3-body basis at the reference demo hyperparameters), through the
shape-bucketed batched dispatch of
ops/featurize_jax.featurize_dataset_device.

Usage: python benchmarks/featurize_throughput.py [n_configs]
"""

import os
import sys
import time


import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.data.composition import ChemicalSystem  # noqa: E402
from uf3_tpu.ops.featurize_jax import featurize_dataset_device  # noqa: E402
from uf3_tpu.representation.basis import BSplineBasis  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501


def build_dataset(n_configs: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    geometries, energies, forces = [], [], []
    for i in range(n_configs):
        geom = bulk("W", "bcc", a=3.1652) * (4, 4, 4)   # 128 atoms
        geom.rattle(0.02 + 0.08 * (i % 5) / 4, seed=i)
        geometries.append(geom)
        energies.append(float(rng.normal(-11.0, 0.1) * len(geom)))
        forces.append(rng.normal(size=(3, len(geom))) * 0.5)
    return geometries, energies, forces


def main():
    require_gpu()
    enable_compile_cache()
    n_configs = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    chemistry = ChemicalSystem(["W"], degree=3)
    basis = BSplineBasis(
        chemistry,
        r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5, 1.5, 1.5]},
        r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
        resolution_map={("W", "W"): 25, ("W", "W", "W"): [6, 6, 12]})
    geometries, energies, forces = build_dataset(n_configs)
    print(f"{n_configs} configs x {len(geometries[0])} atoms, "
          f"platform = {jax.devices()[0].platform}", flush=True)
    # warm-up on a small prefix (compile the bucket shapes)
    featurize_dataset_device(basis, geometries[:2], energies[:2],
                             forces[:2])
    t0 = time.perf_counter()
    x_e, y_e, x_f, y_f = featurize_dataset_device(
        basis, geometries, energies, forces)
    dt = time.perf_counter() - t0
    print(f"x_e {x_e.shape}, x_f {x_f.shape}")
    print(f"{dt:.2f} s total = {dt / n_configs * 1e3:.1f} ms/config "
          f"on {jax.devices()[0].device_kind}")


if __name__ == "__main__":
    main()
