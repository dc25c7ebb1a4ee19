"""
Probe: neighbor-rebuild cost at the bench shape (9826 atoms), pack vs
top-k selection in the cell-list builder, plus the 3-body refilter,
timed on the real accelerator in one session.
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
from uf3_tpu.ops import neighbors as nb  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501

OUT = os.path.join(REPO, "benchmarks_data", "artifacts",
                   "probe_rebuild.json")


def timed(fn, *args, repeats=5):
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e3


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (17, 17, 17)
    system = MDSystem(model, geom, dtype=jnp.float32,
                      rebuild_every=24, skin=0.5, skin_2b=1.2,
                      capacity_2b=72, capacity_3b=16, n_respa=6)
    state = system.init_state(temperature=300.0, seed=0)
    pos = system._wrap(state.positions, system.cell)
    cell = system.cell
    grid_shape, bin_capacity, topology = system._cells_2b
    r2 = system.r_cut_2b + system.skin_2b
    r3 = system.r_cut_3b + system.skin

    results = {"n_atoms": len(geom), "grid_shape": list(grid_shape),
               "bin_capacity": bin_capacity,
               "platform": jax.devices()[0].platform}

    builds = {}
    for sel in ("pack", "topk"):
        fn = jax.jit(lambda p, sel=sel: nb.build_neighbor_list_cells(
            p, cell, system.pbc, r2, system.capacity_2b, grid_shape,
            bin_capacity, topology, with_rev=False,
            assume_wrapped=True, selection=sel))
        nbr, ms = timed(fn, pos)
        builds[sel] = nbr
        results[f"build2b_{sel}_ms"] = round(ms, 3)
        print(sel, round(ms, 3), flush=True)

    # exactness: identical pair sets between the two modes
    import numpy as np
    def pair_set(nbr):
        idx = np.asarray(nbr.idx); mask = np.asarray(nbr.mask)
        sh = np.asarray(nbr.shift).astype(int)
        a = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
        rows = np.stack([a, idx.reshape(-1)] +
                        [sh[..., c].reshape(-1) for c in range(3)],
                        axis=1)[mask.reshape(-1)]
        return set(map(tuple, rows.tolist()))
    results["pair_sets_equal"] = pair_set(builds["pack"]) == \
        pair_set(builds["topk"])

    filt = jax.jit(lambda nbr, p: nb.filter_neighbor_list(
        nbr, p, cell, r3, system.capacity_3b))
    _, ms = timed(filt, builds["pack"], pos)
    results["filter3b_ms"] = round(ms, 3)

    full = jax.jit(lambda p: system.build_lists(p, wrapped=True))
    _, ms = timed(full, pos)
    results["build_lists_ms"] = round(ms, 3)

    print(json.dumps(results))
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
