"""
Device-side UF potential: jit-compiled energy, forces, and virial from
fixed-shape padded neighbor arrays.

Replaces the reference's per-call supercell + dense cdist + per-species
Python loops (uf3/forcefield/calculator.py:124-343) with a scatter-free
formulation built from gathers and row reductions only:

  * 2-body: each ordered pair appears once per endpoint's neighbor row,
    so f_i = sum_j 2 V'(r_ij) u_ij needs no scatter (Newton's third law
    is carried by the list symmetry).
  * 3-body: per-center tensors T(r_cm, r_cn, r_mn) are evaluated once
    over all ordered neighbor pairs; the force a neighbor atom receives
    is recovered by *gathering* the center's tensors through the
    inverse-slot map (NeighborList.rev) -- using the grid transpose
    identity G[s_c, s_n, s_m] = G[s_c, s_m, s_n]^T(1,0,2), the two
    neighbor roles collapse into one gathered term.  No scatter-add
    anywhere in the hot path.

Spline evaluation uses per-cell piecewise polynomials
(uf3_tpu/ops/spline_jax.py): an interval lookup + Horner per leg, one
64-coefficient tricubic per triangle.
"""

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from uf3_tpu.data import elements
from uf3_tpu.ops import spline_jax as sj
from uf3_tpu.ops.neighbors import NeighborList, displacements

# einsum at full f32 precision: a default-precision f32 matmul may
# round its inputs (to TF32 on the GPU, ~2^-11 relative), which is
# fatal for forces/features computed from cell-scale values.  These
# paths are not throughput-critical.
import functools as _functools
_einsum = _functools.partial(jnp.einsum, precision="highest")



class PotentialParams(NamedTuple):
    """Pytree of device tables defining a fitted UF potential."""
    # species mapping: atomic number -> compact species index
    z_to_species: jnp.ndarray        # (max_z + 1,) int32
    offsets_1b: jnp.ndarray          # (S,) per-species energy offsets
    # 2-body tables, padded over P pair types
    pair_type: jnp.ndarray           # (S, S) int32
    pair_poly_e: jnp.ndarray         # (P, I2, 4)
    pair_poly_f: jnp.ndarray         # (P, I2, 4)
    pair_breaks: jnp.ndarray         # (P, I2, 2) [t_lo, 1/h]
    pair_knots: jnp.ndarray          # (P, I2 + 1) interval edges (+inf pad)
    pair_r_min: jnp.ndarray          # (P,)
    pair_r_max: jnp.ndarray          # (P,)
    # 3-body tables, padded over T ordered trio types
    trio_type: jnp.ndarray           # (S, S, S) int32, -1 = absent
    trio_poly: jnp.ndarray           # (T, CL, CM, CN, 64)
    trio_breaks: jnp.ndarray         # (T, 3, I3, 2)
    trio_knots: jnp.ndarray          # (T, 3, I3 + 1) interval edges
    trio_n_cells: jnp.ndarray        # (T, 3) int32
    trio_leg_min: jnp.ndarray        # (T, 3) inclusive leg lower bounds
    trio_leg_max: jnp.ndarray        # (T, 3) inclusive leg upper bounds
    # factorized-path tables (dense grids + knot sequences per type)
    trio_grid: jnp.ndarray           # (T, L, M, NC) coefficient grids
    trio_knot_seq: jnp.ndarray       # (T, 3, KS) knot sequences (pad inf)
    # cutoffs for neighbor-list construction (static copies in metadata)
    r_cut_2b: jnp.ndarray            # () max pair cutoff
    r_cut_3b: jnp.ndarray            # () max center-leg cutoff (0 if no 3B)


class PotentialStatic(NamedTuple):
    """Hashable compile-time metadata for the fast kernels."""
    n_pair_types: int
    # one entry per stored ordered trio type:
    # (type index, center species, leg-1 species, leg-2 species,
    #  L, M, NC basis counts)
    trio_specs: Tuple[Tuple[int, int, int, int, int, int, int], ...]


def _pad_to(array, shape):
    pads = [(0, s - d) for s, d in zip(shape, array.shape)]
    return np.pad(array, pads)


def params_from_model(model, dtype=jnp.float32) -> PotentialParams:
    """Build device tables from a fitted WeightedLinearModel."""
    from uf3_tpu.forcefield.calculator import coefficients_by_interaction
    config = model.bspline_config
    chemical_system = config.chemical_system
    element_list = list(chemical_system.element_list)
    n_species = len(element_list)
    z_list = [elements.atomic_numbers[el] for el in element_list]
    max_z = max(z_list)
    z_to_species = np.zeros(max_z + 1, dtype=np.int32)
    for s, z in enumerate(z_list):
        z_to_species[z] = s
    solutions = coefficients_by_interaction(
        element_list, config.interactions_map, config.partition_sizes,
        model.coefficients)
    offsets_1b = np.array(
        [float(np.asarray(solutions[el]).flat[0]) for el in element_list])

    # -- pair tables --------------------------------------------------------
    pairs = config.interactions_map[2]
    pair_type = np.zeros((n_species, n_species), dtype=np.int32)
    tables = []
    for p_idx, pair in enumerate(pairs):
        s_a = element_list.index(pair[0])
        s_b = element_list.index(pair[1])
        pair_type[s_a, s_b] = p_idx
        pair_type[s_b, s_a] = p_idx
        knots = np.asarray(config.knots_map[pair], dtype=np.float64)
        poly_e, poly_f, breaks = sj.build_pair_tables(
            knots, solutions[pair])
        n_splines = len(knots) - 4
        edges = knots[3:n_splines + 1]
        tables.append((poly_e, poly_f, breaks, edges,
                       max(config.r_min_map[pair], 0.0),
                       config.r_max_map[pair]))
    max_i2 = max(t[0].shape[0] for t in tables)
    pair_poly_e = np.stack([_pad_to(t[0], (max_i2, 4)) for t in tables])
    pair_poly_f = np.stack([_pad_to(t[1], (max_i2, 4)) for t in tables])
    pair_breaks = np.stack([_pad_to(t[2], (max_i2, 2)) for t in tables])
    pair_knots = np.stack([
        np.pad(t[3], (0, max_i2 + 1 - len(t[3])),
               constant_values=np.inf) for t in tables])
    pair_r_min = np.array([t[4] for t in tables])
    pair_r_max = np.array([t[5] for t in tables])
    r_cut_2b = float(np.max(pair_r_max))

    # -- trio tables --------------------------------------------------------
    trio_type = -np.ones((n_species, n_species, n_species), dtype=np.int32)
    trio_tables = []
    trio_specs = []
    r_cut_3b = 0.0
    if config.degree > 2:
        trios = config.interactions_map[3]
        t_idx = 0
        for trio in trios:
            s_c = element_list.index(trio[0])
            s_m = element_list.index(trio[1])
            s_n = element_list.index(trio[2])
            grid = config.decompress_3B(solutions[trio], trio)
            seqs = [np.asarray(s, dtype=np.float64)
                    for s in config.knots_map[trio]]
            variants = [((s_c, s_m, s_n), grid, seqs)]
            if s_m != s_n:
                variants.append(((s_c, s_n, s_m), grid.transpose(1, 0, 2),
                                 [seqs[1], seqs[0], seqs[2]]))
            for key, g, sq in variants:
                trio_type[key] = t_idx
                poly, breaks = sj.build_trio_tables(sq, g)
                edges = [s[3:len(s) - 3] for s in sq]
                leg_min = [s[0] for s in sq]
                leg_max = [s[-1] for s in sq]
                trio_tables.append((poly, breaks, edges, leg_min, leg_max,
                                    g, sq))
                trio_specs.append((t_idx,) + key + g.shape)
                t_idx += 1
            r_cut_3b = max(r_cut_3b, float(max(seqs[0][-1], seqs[1][-1])))
    if trio_tables:
        max_cells = [max(t[0].shape[d] for t in trio_tables)
                     for d in range(3)]
        max_i3 = max(max_cells)
        trio_poly = np.stack([
            _pad_to(t[0], tuple(max_cells) + (64,)) for t in trio_tables])
        trio_breaks = np.stack([
            np.stack([_pad_to(b, (max_i3, 2)) for b in t[1]])
            for t in trio_tables])
        trio_knots = np.stack([
            np.stack([np.pad(e, (0, max_i3 + 1 - len(e)),
                             constant_values=np.inf) for e in t[2]])
            for t in trio_tables])
        trio_n_cells = np.array([[t[0].shape[d] for d in range(3)]
                                 for t in trio_tables], dtype=np.int32)
        trio_leg_min = np.array([t[3] for t in trio_tables])
        trio_leg_max = np.array([t[4] for t in trio_tables])
        max_basis = [max(t[5].shape[d] for t in trio_tables)
                     for d in range(3)]
        trio_grid = np.stack([_pad_to(t[5], tuple(max_basis))
                              for t in trio_tables])
        max_ks = max(len(s) for t in trio_tables for s in t[6])
        trio_knot_seq = np.stack([
            np.stack([np.pad(s, (0, max_ks - len(s)),
                             constant_values=s[-1] + 1e6) for s in t[6]])
            for t in trio_tables])
    else:
        trio_poly = np.zeros((1, 1, 1, 1, 64))
        trio_breaks = np.zeros((1, 3, 1, 2))
        trio_knots = np.full((1, 3, 2), np.inf)
        trio_n_cells = np.ones((1, 3), dtype=np.int32)
        trio_leg_min = np.zeros((1, 3))
        trio_leg_max = np.zeros((1, 3))
        trio_grid = np.zeros((1, 1, 1, 1))
        trio_knot_seq = np.full((1, 3, 8), np.inf)

    def dev(x):
        return jnp.asarray(x, dtype=dtype)

    return PotentialParams(
        z_to_species=jnp.asarray(z_to_species),
        offsets_1b=dev(offsets_1b),
        pair_type=jnp.asarray(pair_type),
        pair_poly_e=dev(pair_poly_e),
        pair_poly_f=dev(pair_poly_f),
        pair_breaks=dev(pair_breaks),
        pair_knots=dev(pair_knots),
        pair_r_min=dev(pair_r_min),
        pair_r_max=dev(pair_r_max),
        trio_type=jnp.asarray(trio_type),
        trio_poly=dev(trio_poly),
        trio_breaks=dev(trio_breaks),
        trio_knots=dev(trio_knots),
        trio_n_cells=jnp.asarray(trio_n_cells),
        trio_leg_min=dev(trio_leg_min),
        trio_leg_max=dev(trio_leg_max),
        trio_grid=dev(trio_grid),
        trio_knot_seq=dev(trio_knot_seq),
        r_cut_2b=dev(r_cut_2b),
        r_cut_3b=dev(r_cut_3b),
    )


def build_potential(model, dtype=jnp.float32
                    ) -> Tuple[PotentialParams, PotentialStatic]:
    """Device tables plus hashable metadata for the fast kernels."""
    params = params_from_model(model, dtype=dtype)
    config = model.bspline_config
    element_list = list(config.chemical_system.element_list)
    specs = []
    if config.degree > 2:
        t_idx = 0
        for trio in config.interactions_map[3]:
            s_c = element_list.index(trio[0])
            s_m = element_list.index(trio[1])
            s_n = element_list.index(trio[2])
            seqs = config.knots_map[trio]
            shape = tuple(len(s) - 4 for s in seqs)
            specs.append((t_idx, s_c, s_m, s_n) + shape)
            t_idx += 1
            if s_m != s_n:
                specs.append((t_idx, s_c, s_n, s_m,
                              shape[1], shape[0], shape[2]))
                t_idx += 1
    static = PotentialStatic(
        n_pair_types=len(config.interactions_map[2]),
        trio_specs=tuple(specs))
    return params, static


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------
def _interval_lookup(r, edges, n_intervals):
    """Branchless searchsorted: edges (..., I+1), r (...,)."""
    idx = jnp.sum(edges < r[..., None], axis=-1) - 1
    return jnp.clip(idx, 0, n_intervals - 1)


def pair_contributions(params: PotentialParams, species, positions, cell,
                       nbr: NeighborList):
    """Per-atom 2-body energies, forces, and the virial tensor."""
    d = displacements(positions, cell, nbr.idx, nbr.shift)  # (N, K, 3)
    r2 = jnp.sum(d * d, axis=-1)
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    s_i = species[:, None]
    s_j = species[nbr.idx]
    ptype = params.pair_type[s_i, s_j]  # (N, K)
    mask = (nbr.mask
            & (r > params.pair_r_min[ptype])
            & (r < params.pair_r_max[ptype]))
    edges = params.pair_knots[ptype]  # (N, K, I+1)
    interval = _interval_lookup(r, edges, params.pair_poly_e.shape[1])
    breaks = params.pair_breaks[ptype, interval]  # (N, K, 2)
    u = (r - breaks[..., 0]) * breaks[..., 1]
    energy = sj.horner_cubic(params.pair_poly_e[ptype, interval], u)
    dvdr = sj.horner_cubic(params.pair_poly_f[ptype, interval], u)
    energy = jnp.where(mask, energy, 0.0)
    dvdr = jnp.where(mask, dvdr, 0.0)
    atom_energy = jnp.sum(energy, axis=1)  # ordered pairs: E = 2x per bond
    unit = d / r[..., None]
    forces = 2.0 * jnp.sum(dvdr[..., None] * unit, axis=1)
    w = dvdr / r
    virial = _einsum("nk,nka,nkb->ab", w, d, d)
    return atom_energy, forces, virial


def pair_contributions_fast(params: PotentialParams,
                            static: PotentialStatic,
                            species, positions, cell,
                            nbr: NeighborList):
    """
    2-body kernel with one-hot interval selection: the per-pair
    polynomial row is obtained as onehot(interval) @ table -- a dense
    matmul instead of an elementwise gather.
    Loops over pair types (few) at trace time.
    """
    d = displacements(positions, cell, nbr.idx, nbr.shift)
    r2 = jnp.sum(d * d, axis=-1)
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    s_j = species[nbr.idx]
    n_int = params.pair_poly_e.shape[1]
    energy = jnp.zeros_like(r)
    dvdr = jnp.zeros_like(r)
    for p in range(static.n_pair_types):
        if static.n_pair_types == 1:
            type_mask = nbr.mask
        else:
            ptype = params.pair_type[species[:, None], s_j]
            type_mask = nbr.mask & (ptype == p)
        mask = (type_mask
                & (r > params.pair_r_min[p]) & (r < params.pair_r_max[p]))
        edges = params.pair_knots[p]  # (I+1,)
        onehot = ((edges[:-1] <= r[..., None])
                  & (r[..., None] < edges[1:]))  # (N, K, I)
        onehot = onehot.astype(r.dtype)
        poly_e = _einsum("nki,id->nkd", onehot,
                            params.pair_poly_e[p])
        poly_f = _einsum("nki,id->nkd", onehot,
                            params.pair_poly_f[p])
        t_lo = _einsum("nki,i->nk", onehot, params.pair_breaks[p, :, 0])
        inv_h = _einsum("nki,i->nk", onehot,
                           params.pair_breaks[p, :, 1])
        u = (r - t_lo) * inv_h
        energy = energy + jnp.where(mask, sj.horner_cubic(poly_e, u), 0.0)
        dvdr = dvdr + jnp.where(mask, sj.horner_cubic(poly_f, u), 0.0)
    atom_energy = jnp.sum(energy, axis=1)
    unit = d / r[..., None]
    forces = 2.0 * jnp.sum(dvdr[..., None] * unit, axis=1)
    w = dvdr / r
    virial = _einsum("nk,nka,nkb->ab", w, d, d)
    return atom_energy, forces, virial


def _dense_leg_basis(r, knot_seq, n_splines, valid, nu=0):
    """4-tap de Boor values scattered into a dense (..., n_splines)
    basis matrix.  Written as four fused select-adds so no
    (..., 4, n_splines) intermediate materializes."""
    values, idx = sj.deboor_values_jax(r, knot_seq, nu=nu)
    in_range = valid & (r >= knot_seq[0]) & (r <= knot_seq[-1])
    values = jnp.where(in_range[..., None], values, 0.0)
    rel = jnp.arange(n_splines) - idx[..., None]  # (..., n_splines)
    out = jnp.zeros(r.shape + (n_splines,), dtype=values.dtype)
    for tap in range(4):
        out = out + jnp.where(rel == tap, values[..., tap, None], 0.0)
    return out


def trio_contributions_factorized(params: PotentialParams,
                                  static: PotentialStatic,
                                  species, positions, cell,
                                  nbr3: NeighborList):
    """
    3-body kernel as dense tensor contractions (matmul-shaped):

      T[m, n]  = sum_abc A[m, a] B[n, b] C[m, n, c] G[a, b, c]

    with A/B/C dense per-leg basis matrices built from the branchless
    4-tap de Boor kernel, evaluated per ordered trio type.  Leg-range
    masks live in zeroed basis rows; trimmed/symmetry-dead coefficients
    are zeros of G.  Avoids the per-triangle 64-coefficient gather of
    the table path entirely.  Neighbor forces are recovered through the
    inverse-slot gather exactly as in trio_contributions.
    """
    n_atoms, k3 = nbr3.idx.shape
    d = displacements(positions, cell, nbr3.idx, nbr3.shift)  # (N, K, 3)
    r2 = jnp.sum(d * d, axis=-1)
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    s_nb = species[nbr3.idx]
    d_mn = d[:, None, :, :] - d[:, :, None, :]
    r_mn2 = jnp.sum(d_mn * d_mn, axis=-1)
    r_mn = jnp.sqrt(jnp.where(r_mn2 > 0, r_mn2, 1.0))
    not_diag = ~jnp.eye(k3, dtype=bool)[None]
    pair_ok = (nbr3.mask[:, :, None] & nbr3.mask[:, None, :] & not_diag
               & (r_mn2 > 1e-10))

    value_acc = jnp.zeros((n_atoms, k3, k3), dtype=r.dtype)
    g1 = jnp.zeros_like(value_acc)
    g2 = jnp.zeros_like(value_acc)
    g3 = jnp.zeros_like(value_acc)
    n_species = params.offsets_1b.shape[0]
    for (t, s_c, s_m, s_n, L, M, NC) in static.trio_specs:
        grid = params.trio_grid[t, :L, :M, :NC]
        seq_l = params.trio_knot_seq[t, 0, :L + 4]
        seq_m = params.trio_knot_seq[t, 1, :M + 4]
        seq_n = params.trio_knot_seq[t, 2, :NC + 4]
        center_ok = (species == s_c) if n_species > 1 \
            else jnp.ones((n_atoms,), dtype=bool)
        m_ok = nbr3.mask & ((s_nb == s_m) if n_species > 1
                            else jnp.ones_like(nbr3.mask))
        n_ok = nbr3.mask & ((s_nb == s_n) if n_species > 1
                            else jnp.ones_like(nbr3.mask))
        a_mat = _dense_leg_basis(r, seq_l, L, m_ok)          # (N, K, L)
        da_mat = _dense_leg_basis(r, seq_l, L, m_ok, nu=1)
        b_mat = _dense_leg_basis(r, seq_m, M, n_ok)          # (N, K, M)
        db_mat = _dense_leg_basis(r, seq_m, M, n_ok, nu=1)
        c_mat = _dense_leg_basis(r_mn, seq_n, NC, pair_ok)   # (N,K,K,NC)
        dc_mat = _dense_leg_basis(r_mn, seq_n, NC, pair_ok, nu=1)
        h = _einsum("nia,abc->nibc", a_mat, grid)     # (N, K, M, NC)
        h1 = _einsum("nia,abc->nibc", da_mat, grid)
        dd = _einsum("nijc,nibc->nijb", c_mat, h)     # (N, K, K, M)
        d1 = _einsum("nijc,nibc->nijb", c_mat, h1)
        d3 = _einsum("nijc,nibc->nijb", dc_mat, h)
        value = _einsum("njb,nijb->nij", b_mat, dd)
        t1 = _einsum("njb,nijb->nij", b_mat, d1)
        t2 = _einsum("njb,nijb->nij", db_mat, dd)
        t3 = _einsum("njb,nijb->nij", b_mat, d3)
        c_w = center_ok[:, None, None].astype(r.dtype)
        value_acc = value_acc + value * c_w
        g1 = g1 + t1 * c_w
        g2 = g2 + t2 * c_w
        g3 = g3 + t3 * c_w

    atom_energy = 0.5 * jnp.sum(value_acc, axis=(1, 2))
    unit = d / r[..., None]
    forces = jnp.sum(jnp.sum(g1, axis=2)[..., None] * unit, axis=1)
    from uf3_tpu.ops.neighbors import gather_rows
    k3c = nbr3.idx.shape[1]
    flat = (nbr3.idx.astype(jnp.int32) * k3c
            + nbr3.rev.astype(jnp.int32))
    g1_rows = gather_rows(g1.reshape(-1, k3c), flat)
    g3_rows = gather_rows(g3.reshape(-1, k3c), flat)
    r_an = gather_rows(r_mn.reshape(-1, k3c), flat)
    d_cn = gather_rows(d.reshape(n_atoms, -1), nbr3.idx).reshape(
        n_atoms, k3c, k3c, 3)
    d_an = d[:, :, None, :] + d_cn
    term1 = jnp.sum(g1_rows, axis=2)[..., None] * unit
    term2 = jnp.sum((g3_rows / r_an)[..., None] * d_an, axis=2)
    forces = forces + jnp.sum(jnp.where(nbr3.mask[..., None],
                                        term1 + term2, 0.0), axis=1)
    virial = 0.5 * (
        _einsum("nm,nma,nmb->ab", jnp.sum(g1, axis=2) / r, d, d)
        + _einsum("nm,nma,nmb->ab", jnp.sum(g2, axis=1) / r, d, d)
        + _einsum("nmk,nmka,nmkb->ab", g3 / r_mn, d_mn, d_mn))
    return atom_energy, forces, virial


def trio_contributions(params: PotentialParams, species, positions, cell,
                       nbr3: NeighborList):
    """
    Per-atom 3-body energies, forces, and the virial, scatter-free.

    Center pass: for every atom c and ordered neighbor pair (m, n),
    T = G[s_c, s_m, s_n](r_cm, r_cn, r_mn) and its three leg derivatives
    (G1, G2, G3).  E_c = 1/2 sum T.  Neighbor forces are recovered by
    gathering the center tensors via the inverse-slot map.
    """
    n_atoms, k3 = nbr3.idx.shape
    d = displacements(positions, cell, nbr3.idx, nbr3.shift)  # (N, K, 3)
    r2 = jnp.sum(d * d, axis=-1)
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))  # (N, K)
    s_m = species[nbr3.idx]  # (N, K)
    ttype = params.trio_type[species[:, None, None], s_m[:, :, None],
                             s_m[:, None, :]]  # (N, K, K)
    t_safe = jnp.maximum(ttype, 0)
    # leg distances
    r_cm = r[:, :, None]
    r_cn = r[:, None, :]
    d_mn = d[:, None, :, :] - d[:, :, None, :]  # (N, K, K, 3)
    r_mn2 = jnp.sum(d_mn * d_mn, axis=-1)
    r_mn = jnp.sqrt(jnp.where(r_mn2 > 0, r_mn2, 1.0))
    # masks: valid slots, distinct entries, species table present,
    # per-leg inclusive knot ranges
    eye = jnp.eye(k3, dtype=bool)
    leg_min = params.trio_leg_min[t_safe]  # (N, K, K, 3)
    leg_max = params.trio_leg_max[t_safe]
    mask = (nbr3.mask[:, :, None] & nbr3.mask[:, None, :]
            & ~eye[None, :, :]
            & (ttype >= 0)
            & (r_cm >= leg_min[..., 0]) & (r_cm <= leg_max[..., 0])
            & (r_cn >= leg_min[..., 1]) & (r_cn <= leg_max[..., 1])
            & (r_mn >= leg_min[..., 2]) & (r_mn <= leg_max[..., 2]))
    # interval lookups per leg
    i3 = params.trio_poly.shape[1:4]
    il = _interval_lookup(r_cm, params.trio_knots[t_safe, 0], i3[0])
    im = _interval_lookup(r_cn, params.trio_knots[t_safe, 1], i3[1])
    iw = _interval_lookup(r_mn, params.trio_knots[t_safe, 2], i3[2])
    br_l = params.trio_breaks[t_safe, 0, il]  # (N, K, K, 2)
    br_m = params.trio_breaks[t_safe, 1, im]
    br_n = params.trio_breaks[t_safe, 2, iw]
    u = (r_cm - br_l[..., 0]) * br_l[..., 1]
    v = (r_cn - br_m[..., 0]) * br_m[..., 1]
    w = (r_mn - br_n[..., 0]) * br_n[..., 1]
    cells = params.trio_poly[t_safe, il, im, iw]  # (N, K, K, 64)
    value, d_du, d_dv, d_dw = sj.tricubic_eval(cells, u, v, w)
    g1 = jnp.where(mask, d_du * br_l[..., 1], 0.0)  # d/d r_cm
    g2 = jnp.where(mask, d_dv * br_m[..., 1], 0.0)  # d/d r_cn
    g3 = jnp.where(mask, d_dw * br_n[..., 1], 0.0)  # d/d r_mn
    value = jnp.where(mask, value, 0.0)

    atom_energy = 0.5 * jnp.sum(value, axis=(1, 2))
    # center-force term: dE_c/dR_c = sum_mn g1 * (-u_cm)  (by m<->n
    # symmetry of the double sum); f_c = sum_mn g1 * u_cm.
    unit = d / r[..., None]  # (N, K, 3)
    w_m = jnp.sum(g1, axis=2)  # (N, K)
    forces = jnp.sum(w_m[..., None] * unit, axis=1)
    # neighbor-force term: gather the center tensors.  For atom a with
    # neighbor c = idx[a, s] at reverse slot p = rev[a, s]:
    #   f_a += sum_n [ g1[c, p, n] * d_ac / r_ac
    #                + g3[c, p, n] * d_an / r_an ]
    # where d_an = d_ac + d_cn and r_an = r_mn[c, p, n].
    from uf3_tpu.ops.neighbors import gather_rows
    k3c = nbr3.idx.shape[1]
    flat = (nbr3.idx.astype(jnp.int32) * k3c
            + nbr3.rev.astype(jnp.int32))    # flat (c, slot) rows
    g1_rows = gather_rows(g1.reshape(-1, k3c), flat)  # (N, K, K)
    g3_rows = gather_rows(g3.reshape(-1, k3c), flat)
    r_an = gather_rows(r_mn.reshape(-1, k3c), flat)
    d_cn = gather_rows(d.reshape(n_atoms, -1), nbr3.idx).reshape(
        n_atoms, k3c, k3c, 3)
    d_an = d[:, :, None, :] + d_cn  # a -> n via c: d_ac + d_cn
    term1 = jnp.sum(g1_rows, axis=2)[..., None] * unit  # (N, K, 3)
    term2 = jnp.sum((g3_rows / r_an)[..., None] * d_an, axis=2)
    forces = forces + jnp.sum(jnp.where(nbr3.mask[..., None],
                                        term1 + term2, 0.0), axis=1)
    # virial: 1/2 sum over ordered pairs of the three leg outer products
    virial = 0.5 * (
        _einsum("nm,nma,nmb->ab", jnp.sum(g1, axis=2) / r, d, d)
        + _einsum("nm,nma,nmb->ab", jnp.sum(g2, axis=1) / r, d, d)
        + _einsum("nmk,nmka,nmkb->ab", g3 / r_mn, d_mn, d_mn))
    return atom_energy, forces, virial


def compute_energy_forces(params: PotentialParams, species, positions,
                          cell, nbr2: NeighborList,
                          nbr3: NeighborList = None,
                          static: PotentialStatic = None):
    """Total energy, per-atom forces, and virial tensor.  With
    ``static`` metadata the gather-free fast kernels are used."""
    e1 = jnp.sum(params.offsets_1b[species])
    if static is not None:
        e2, f2, w2 = pair_contributions_fast(params, static, species,
                                             positions, cell, nbr2)
    else:
        e2, f2, w2 = pair_contributions(params, species, positions, cell,
                                        nbr2)
    energy = e1 + jnp.sum(e2)
    forces = f2
    virial = w2
    if nbr3 is not None:
        if static is not None:
            e3, f3, w3 = trio_contributions_factorized(
                params, static, species, positions, cell, nbr3)
        else:
            e3, f3, w3 = trio_contributions(params, species, positions,
                                            cell, nbr3)
        energy = energy + jnp.sum(e3)
        forces = forces + f3
        virial = virial + w3
    return energy, forces, virial


def stress_voigt(virial, volume):
    """Voigt stress (xx, yy, zz, yz, xz, xy) from the virial tensor."""
    sigma = virial / volume
    return jnp.array([sigma[0, 0], sigma[1, 1], sigma[2, 2],
                      sigma[1, 2], sigma[0, 2], sigma[0, 1]])
