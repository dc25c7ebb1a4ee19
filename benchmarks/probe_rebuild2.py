"""
Rebuild-kernel probe: time the full cell-list rebuild (2B build +
3B refilter, the _full branch of MDSystem._rebuild_switch) for the
selection variants at the bench and scaling sizes.

The single-stage pack re-reads the (rows, 27*cap_b) candidate plane
once per capacity slot, ~8 GB of memory traffic at 9,826 atoms.  The
blocked two-stage pack ("pack2", neighbors.build_neighbor_list_cells)
bounds the plane to a lax.map block and extracts group-locally.

Timing is scan-chained (lax.scan over the build with a data
dependency, minus a null scan), so the per-launch dispatch cost does
not enter the rebuild time.

Writes benchmarks_data/artifacts/probe_rebuild2.json.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu.ops import neighbors as nb  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501

OUT = os.path.join(REPO, "benchmarks_data", "artifacts",
                   "probe_rebuild2.json")


def chain_ms(fn, x, iters=24):
    """Scan-chain fn over a position-perturbation dependency."""

    @jax.jit
    def run(x):
        def body(c, _):
            nbr2, nbr3 = fn(c)
            # data dependency: nudge positions by a parity flip of the
            # first list's mask count so the scan cannot collapse
            bump = (jnp.sum(nbr2.mask) % 2).astype(c.dtype) * 1e-7
            return c + bump, None
        c, _ = jax.lax.scan(body, x, None, length=iters)
        return c

    out = run(x)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = run(x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def null_ms(x, iters=24):
    @jax.jit
    def run(x):
        def body(c, _):
            return c + 1e-7, None
        c, _ = jax.lax.scan(body, x, None, length=iters)
        return c

    out = run(x)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = run(x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    require_gpu()
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    out = {"platform": jax.devices()[0].platform, "sizes": []}
    for reps in [(17, 17, 17), (34, 17, 17), (34, 34, 17)]:
        geom = bulk("W", "bcc", a=3.1652) * reps
        n = len(geom)
        system = MDSystem(model, geom, dtype=jnp.float32,
                          rebuild_every=36, skin=0.5, skin_2b=1.2,
                          capacity_2b=72, capacity_3b=16, n_respa=12,
                          respa_mid=6, respa_switch=(2.5, 3.5))
        x = system._wrap(jnp.asarray(np.array(geom.positions),
                                     dtype=jnp.float32), system.cell)
        entry = {"n_atoms": n,
                 "grid": list(system._cells_2b[0]),
                 "bin_capacity": system._cells_2b[1],
                 "null_ms": round(null_ms(x), 4)}
        for sel in ("pack", "pack2"):
            grid_shape, bin_capacity, topology = system._cells_2b

            def build(pos, _sel=sel):
                nbr2 = nb.build_neighbor_list_cells(
                    pos, system.cell, system.pbc,
                    system.r_cut_2b + system.skin_2b,
                    system.capacity_2b, grid_shape, bin_capacity,
                    topology, with_rev=False, assume_wrapped=True,
                    selection=_sel)
                nbr3 = nb.filter_neighbor_list(
                    nbr2, pos, system.cell,
                    system.r_cut_3b + system.skin, system.capacity_3b)
                return nbr2, nbr3

            ms = chain_ms(build, x)
            entry[sel + "_ms"] = round(ms, 4)
            entry[sel + "_net_ms"] = round(ms - entry["null_ms"], 4)
        # cross-check the two selections agree on device
        g, bc, topo = system._cells_2b
        a = nb.build_neighbor_list_cells(
            x, system.cell, system.pbc,
            system.r_cut_2b + system.skin_2b, system.capacity_2b,
            g, bc, topo, with_rev=False, assume_wrapped=True,
            selection="pack")
        b = nb.build_neighbor_list_cells(
            x, system.cell, system.pbc,
            system.r_cut_2b + system.skin_2b, system.capacity_2b,
            g, bc, topo, with_rev=False, assume_wrapped=True,
            selection="pack2")
        entry["device_bitwise_equal"] = bool(
            jnp.array_equal(a.idx, b.idx)
            & jnp.array_equal(a.mask, b.mask)
            & jnp.array_equal(a.shift, b.shift))
        out["sizes"].append(entry)
        print(json.dumps(entry), flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "sizes"}))


if __name__ == "__main__":
    main()
