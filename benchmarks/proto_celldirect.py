"""
Prototype benchmark: cell-direct pair forces (dense stencil candidate
evaluation over the binned layout, zero per-atom row gathers) vs the
gather-based pair kernel.  Also measures gather sensitivity to index
locality.
"""

import os
import sys
import time


import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from uf3_tpu.data.atoms import bulk  # noqa: E402
from uf3_tpu.forcefield.md import MDSystem  # noqa: E402
from uf3_tpu.ops import neighbors as nb  # noqa: E402
from uf3_tpu.ops import pallas_trio as pt  # noqa: E402
from uf3_tpu.regression import least_squares as ls  # noqa: E402
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu  # noqa: E402,E501


def timeit(fn, *args, iters=50, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    require_gpu()
    enable_compile_cache()
    reps = 17
    model = ls.WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * (reps, reps, reps)
    n = len(geom)
    dtype = jnp.float32
    system = MDSystem(model, geom, dtype=dtype, rebuild_every=18,
                      skin=0.5, skin_2b=1.2, capacity_2b=72,
                      capacity_3b=16)
    print(f"n_atoms = {n}, platform = {jax.devices()[0].platform}")

    # ---- binned layout from the existing cell-list geometry ---------
    r_cut = system.r_cut_2b + system.skin_2b
    grid_shape, bin_capacity, topology = system._cells_2b
    nbr_bins, nbr_shifts, nbr_valid = (np.asarray(t) for t in topology)
    nx, ny, nz = grid_shape
    n_bins = nx * ny * nz
    cap_b = bin_capacity
    print(f"bins {grid_shape} cap_b={cap_b} "
          f"candidates/atom = {27 * cap_b}")
    pos = np.asarray(system._positions0)
    cell = np.asarray(system.cell)
    frac = pos @ np.linalg.inv(cell)
    frac -= np.floor(frac)
    coord = np.clip((frac * grid_shape).astype(int), 0,
                    np.asarray(grid_shape) - 1)
    bin_id = (coord[:, 0] * ny + coord[:, 1]) * nz + coord[:, 2]
    order = np.argsort(bin_id, kind="stable")
    sorted_bid = bin_id[order]
    starts = np.searchsorted(sorted_bid, np.arange(n_bins), "left")
    counts = np.diff(np.append(starts, n))
    assert counts.max() <= cap_b
    # slot layout (B, cap_b): atom index or -1
    slot_atom = np.full((n_bins, cap_b), -1, dtype=np.int32)
    for b in range(n_bins):
        slot_atom[b, :counts[b]] = order[starts[b]:starts[b]
                                         + counts[b]]
    mask_b = slot_atom >= 0
    pos_b = np.zeros((n_bins, cap_b, 3), dtype=np.float32)
    pos_b[mask_b] = pos[slot_atom[mask_b]]

    pos_bj = jnp.asarray(pos_b)
    mask_j = jnp.asarray(mask_b)
    nbrb_j = jnp.asarray(nbr_bins)
    shifts_cart = jnp.asarray(
        (nbr_shifts.reshape(-1, 3) @ cell).reshape(n_bins, 27, 3),
        dtype=dtype)

    spec, coeff = system.pair_fast
    t_min, t_max = spec.t_min, spec.t_max

    @jax.jit
    def cell_direct(pos_bj):
        # candidate tables: (B, 27 * cap_b) per component via one
        # (B, 27)-row gather from the (B, cap_b) component tables
        f_out = []
        candc = []
        cmask = (mask_j.reshape(-1)[
            nbrb_j.reshape(-1) * cap_b
            + jnp.arange(cap_b)[None, :].repeat(27 * n_bins, 0)
            .reshape(-1, cap_b).reshape(-1)]) if False else None
        # simpler: gather (B, 27) rows of the flattened tables
        pm = mask_j.astype(dtype)
        cand_mask = pm.at[nbrb_j.reshape(-1)].get(
            mode="promise_in_bounds").reshape(n_bins, 27, cap_b)
        comps = []
        for c in range(3):
            t = pos_bj[..., c]
            candx = t.at[nbrb_j.reshape(-1)].get(
                mode="promise_in_bounds").reshape(n_bins, 27, cap_b)
            candx = candx + shifts_cart[:, :, c][:, :, None]
            comps.append(candx.reshape(n_bins, 1, 27 * cap_b)
                         - pos_bj[..., c][:, :, None])
        r2 = comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2
        r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
        valid = (cand_mask.reshape(n_bins, 1, -1) * pm[:, :, None]
                 * (r > t_min).astype(dtype)
                 * (r < t_max).astype(dtype)
                 * (r2 > 1e-10).astype(dtype))
        values, derivs, idx = pt._cardinal4(r, spec)
        dv = jnp.zeros_like(r)
        for tap in range(4):
            c_tap = jnp.zeros_like(r)
            for w in range(spec.n_basis):
                c_tap = jnp.where(idx + tap == w, coeff[w], c_tap)
            dv = dv + derivs[tap] * c_tap
        w_pair = 2.0 * dv * valid / r
        forces = [jnp.sum(w_pair * dc, axis=2) for dc in comps]
        return jnp.stack(forces, axis=-1)   # (B, cap_b, 3)

    t_cd = timeit(cell_direct, pos_bj)
    print(f"cell-direct pair forces:   {t_cd:7.3f} ms")

    # blocked variant with lax.map to bound intermediates
    for g in (32, 64, 128):
        @jax.jit
        def cell_direct_blk(pos_bj, g=g):
            pm = mask_j.astype(dtype)
            cand_mask = pm.at[nbrb_j.reshape(-1)].get(
                mode="promise_in_bounds").reshape(n_bins, 27, cap_b)
            cands = []
            for c in range(3):
                t = pos_bj[..., c]
                candx = t.at[nbrb_j.reshape(-1)].get(
                    mode="promise_in_bounds").reshape(n_bins, 27,
                                                      cap_b)
                cands.append(candx + shifts_cart[:, :, c][:, :, None])
            pad = (-n_bins) % g
            nb_pad = (n_bins + pad) // g

            def blocks(a):
                return jnp.pad(
                    a.reshape(n_bins, -1),
                    ((0, pad), (0, 0))).reshape(nb_pad, g, -1)

            def blk(args):
                cx, cy, cz, cm, px, py, pz, pmv = args
                comps = [cx.reshape(g, 1, -1) - px[..., None]
                         .transpose(0, 1, 2).reshape(g, cap_b, 1),
                         cy.reshape(g, 1, -1)
                         - py.reshape(g, cap_b, 1),
                         cz.reshape(g, 1, -1)
                         - pz.reshape(g, cap_b, 1)]
                comps[0] = cx.reshape(g, 1, -1) \
                    - px.reshape(g, cap_b, 1)
                r2 = comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2
                r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
                valid = (cm.reshape(g, 1, -1)
                         * pmv.reshape(g, cap_b, 1)
                         * (r > t_min).astype(dtype)
                         * (r < t_max).astype(dtype)
                         * (r2 > 1e-10).astype(dtype))
                values, derivs, idx = pt._cardinal4(r, spec)
                dv = jnp.zeros_like(r)
                for tap in range(4):
                    c_tap = jnp.zeros_like(r)
                    for w in range(spec.n_basis):
                        c_tap = jnp.where(idx + tap == w, coeff[w],
                                          c_tap)
                    dv = dv + derivs[tap] * c_tap
                w_pair = 2.0 * dv * valid / r
                return jnp.stack(
                    [jnp.sum(w_pair * dc, axis=2) for dc in comps],
                    axis=-1)

            args = tuple(blocks(a) for a in (
                cands[0], cands[1], cands[2], cand_mask,
                pos_bj[..., 0], pos_bj[..., 1], pos_bj[..., 2], pm))
            return jax.lax.map(blk, args)

        print(f"cell-direct blocked g={g:3d}: "
              f"{timeit(cell_direct_blk, pos_bj):7.3f} ms")

    # ---- gather locality probe --------------------------------------
    posj = jnp.asarray(pos, dtype=dtype)
    rng = np.random.RandomState(0)
    idx_local = np.sort(rng.randint(0, n, size=(n * 72,)).reshape(
        n, 72), axis=1)
    # local: each row's indices near the row id
    idx_near = np.clip(np.arange(n)[:, None]
                       + rng.randint(-40, 40, size=(n, 72)), 0, n - 1)
    idx_rand = rng.randint(0, n, size=(n, 72))
    for name, idx in (("near", idx_near), ("rand", idx_rand)):
        flats = pt.blockify_columns(jnp.asarray(idx.T))

        @jax.jit
        def g(p, flats=flats):
            return pt.gather_rows_blocks(p, flats, n)

        print(f"gather (N,72) {name}:      {timeit(g, posj):7.3f} ms")


if __name__ == "__main__":
    main()
