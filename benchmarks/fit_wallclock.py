"""
End-to-end fit-path wall-clock: device featurization of a
w-14-scale dataset (1,939 configurations; the qmml.org tungsten set
is not bundled, so the workload is 1,939 rattled bcc cells at 54/128
atoms -- slightly HEAVIER per config than w-14's mixed 1-128-atom
cells) + the weighted gram/solve, at the reference demo
hyperparameters.  The reference counterpart is the process_df +
fit_from_file pipeline (uf3/representation/process.py:256,
uf3/regression/least_squares.py:355), which parallelizes featurize
over CPU processes.

Writes benchmarks_data/artifacts/fit_wallclock.json.

Usage: python benchmarks/fit_wallclock.py [n_configs]
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import rattled_bcc_dataset  # noqa: E402
from uf3_tpu.data.composition import ChemicalSystem  # noqa: E402
from uf3_tpu.ops.featurize_jax import featurize_dataset_device  # noqa: E402
from uf3_tpu.regression.least_squares import WeightedLinearModel  # noqa: E402
from uf3_tpu.representation.basis import BSplineBasis  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501

OUT = os.path.join(REPO, "benchmarks_data", "artifacts",
                   "fit_wallclock.json")


def main():
    require_gpu()
    enable_compile_cache()
    n_configs = int(sys.argv[1]) if len(sys.argv) > 1 else 1939
    chemistry = ChemicalSystem(["W"], degree=3)
    basis = BSplineBasis(
        chemistry,
        r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5, 1.5, 1.5]},
        r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
        resolution_map={("W", "W"): 25, ("W", "W", "W"): [6, 6, 12]})
    geometries, energies, forces = rattled_bcc_dataset(n_configs)
    n_atoms_total = sum(len(g) for g in geometries)

    # warm-up: compile the two bucket shapes
    featurize_dataset_device(basis, geometries[:4], energies[:4],
                             forces[:4])
    t0 = time.perf_counter()
    x_e, y_e, x_f, y_f = featurize_dataset_device(
        basis, geometries, energies, forces)
    t_feat = time.perf_counter() - t0

    model = WeightedLinearModel(basis, c2=1e-8, c3=1e-8)
    t0 = time.perf_counter()
    model.fit(np.asarray(x_e), np.asarray(y_e),
              np.asarray(x_f), np.asarray(y_f), weight=0.5)
    t_solve = time.perf_counter() - t0

    result = {
        "metric": "tungsten-scale fit (featurize + solve) wall-clock",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "n_configs": n_configs,
        "n_atoms_total": n_atoms_total,
        "n_force_rows": int(np.asarray(x_f).shape[0]),
        "featurize_s": round(t_feat, 2),
        "featurize_ms_per_config": round(t_feat / n_configs * 1e3, 2),
        "solve_s": round(t_solve, 2),
        "total_s": round(t_feat + t_solve, 2),
    }
    print(json.dumps(result))
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
