"""
Device featurization (JAX): energy and force feature vectors for
training, computed with the same scatter-free algebra as the MD force
kernel but resolved per basis function.

For every center c and neighbor slot m, the partial tensors

    P0[c, m, g]      = sum_n  A[c, m] (x) B[c, n] (x) C[c, m, n]   [g]
    P1[c, m, g]      = sum_n dA[c, m] (x) B[c, n] (x) C[c, m, n]   [g]
    P3[c, m, g]      = sum_n  A[c, m] (x) B[c, n] (x) (dC/r)[c,m,n][g]
    PV[c, m, g, xyz] = sum_n  A (x) B (x) (dC/r) * d[c, n, xyz]    [g]

(g runs over the flattened L*M*NC coefficient grid) give

    energy grid      Phi[g]        = 1/2 sum_cm P0[c, m, g]
    force features   X[a, xyz, g]  = -( sum_m P1[a, m, g] u_am
                                      + sum_s gathered neighbor terms )

exactly mirroring uf3_tpu/ops/potential.py's force identities with the
coefficient contraction removed.  The host oracle
(uf3_tpu/representation/featurize_np.py) pins the numbers; this path is
the fast (device) twin for large training sets.  Single-trio-type
(unary) fast path; multi-species falls back to the host featurizer.
"""

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from uf3_tpu.ops.neighbors import cell_transform

from uf3_tpu.ops.pallas_trio import LegSpec, _dense_basis

# einsum at full f32 precision: a default-precision f32 matmul may
# round its inputs (to TF32 on the GPU, ~2^-11 relative), which is
# fatal for forces/features computed from cell-scale values.  These
# paths are not throughput-critical.
import functools as _functools
_einsum = _functools.partial(jnp.einsum, precision="highest")



class FeaturizeSpec(NamedTuple):
    """Static description for the single-pair/single-trio device path."""
    pair: LegSpec            # 2-body leg (full knot sequence)
    pair_lead: int
    pair_trail: int
    trio_l: LegSpec          # 3-body center legs (shared)
    trio_n: LegSpec          # 3-body third leg
    trio_lead: int
    trio_trail: int
    l_basis: int
    n_basis: int


def _trimmed_basis(r, valid, spec: LegSpec, lead: int, trail: int):
    mat, dmat = _dense_basis(r, valid, spec)
    n_basis = spec.n_basis
    if lead > 0 or trail > 0:
        keep = jnp.zeros((n_basis,), dtype=bool).at[
            lead:n_basis - trail].set(True)
        mat = jnp.where(keep, mat, 0.0)
        dmat = jnp.where(keep, dmat, 0.0)
    return mat, dmat


@functools.partial(jax.jit, static_argnames=("spec",))
def featurize_device(spec: FeaturizeSpec,
                     positions, cell,
                     nbr_idx, nbr_shift, nbr_mask, nbr_rev,
                     nbr3_idx, nbr3_shift, nbr3_mask, nbr3_rev):
    """
    Energy + force features for one configuration (unary system).

    Returns:
        e2: (n_pair_basis,) 2-body energy features
        f2: (N, 3, n_pair_basis) 2-body force features
        e3: (L, L, NC) 3-body energy grid (uncompressed)
        f3: (N, 3, L, L, NC) 3-body force grids (uncompressed,
            reference sign convention)
    """
    n_atoms = positions.shape[0]
    # ---- 2-body -----------------------------------------------------------
    d2v = (positions[nbr_idx] + cell_transform(nbr_shift, cell)
           - positions[:, None, :])
    r2sq = jnp.sum(d2v * d2v, axis=-1)
    r2 = jnp.sqrt(jnp.where(r2sq > 0, r2sq, 1.0))
    # strict bounds (reference distances.py:66: r_min < r < r_max)
    valid2 = (nbr_mask & (r2 > spec.pair.t_min) & (r2 < spec.pair.t_max))
    a2, da2 = _trimmed_basis(r2, valid2, spec.pair, spec.pair_lead,
                             spec.pair_trail)
    e2 = jnp.sum(a2, axis=(0, 1))
    unit2 = d2v / r2[..., None]
    # x[a, xyz, s] = 2 sum_k B'_s(r_ak) u_ak  (both bond orientations)
    f2 = 2.0 * _einsum("nks,nkc->ncs", da2, unit2)

    # ---- 3-body -----------------------------------------------------------
    k3 = nbr3_idx.shape[1]
    d = (positions[nbr3_idx] + cell_transform(nbr3_shift, cell)
         - positions[:, None, :])
    rsq = jnp.sum(d * d, axis=-1)
    r = jnp.sqrt(jnp.where(rsq > 0, rsq, 1.0))
    a_mat, da_mat = _trimmed_basis(r, nbr3_mask, spec.trio_l,
                                   spec.trio_lead, spec.trio_trail)
    d_mn = d[:, None, :, :] - d[:, :, None, :]
    r_mn2 = jnp.sum(d_mn * d_mn, axis=-1)
    r_mn = jnp.sqrt(jnp.where(r_mn2 > 0, r_mn2, 1.0))
    pair_ok = (nbr3_mask[:, :, None] & nbr3_mask[:, None, :]
               & (r_mn2 > 1e-10))
    c_mat, dc_mat = _trimmed_basis(r_mn, pair_ok, spec.trio_n,
                                   spec.trio_lead, spec.trio_trail)
    dc_over_r = dc_mat / r_mn[..., None]
    l_dim, nc = spec.l_basis, spec.n_basis
    # BC[c, m, n, (b, w)] contracted over n first:
    #   Q [c, m, b, w] = sum_n B[c, n, b] C[c, m, n, w]
    #   Q3[c, m, b, w] = sum_n B[c, n, b] (dC/r)[c, m, n, w]
    #   QV[c, m, b, w, xyz] = sum_n B (dC/r) d[c, n, xyz]
    q0 = _einsum("cnb,cmnw->cmbw", a_mat, c_mat)
    q3 = _einsum("cnb,cmnw->cmbw", a_mat, dc_over_r)
    qv = _einsum("cnb,cmnw,cnx->cmbwx", a_mat, dc_over_r, d)
    # per-(center, slot) grid partials (N, K, L, M, NC)
    p0 = _einsum("cma,cmbw->cmabw", a_mat, q0)
    p1 = _einsum("cma,cmbw->cmabw", da_mat, q0)
    p3 = _einsum("cma,cmbw->cmabw", a_mat, q3)
    pv = _einsum("cma,cmbwx->cmabwx", a_mat, qv)
    # energy grid: ordered pairs double-count -> 1/2
    e3 = 0.5 * jnp.sum(p0, axis=(0, 1))
    # center term: sum_m P1[a, m, g] * u_am
    unit = d / r[..., None]
    grid_center = _einsum("cmabw,cmx->cxabw", p1, unit)
    # neighbor term: gather partials through the inverse slots
    flat = (nbr3_idx.astype(jnp.int32) * k3
            + nbr3_rev.astype(jnp.int32)).reshape(-1)
    grid_size = l_dim * l_dim * nc
    p1_rows = p1.reshape(-1, grid_size).at[flat].get(
        mode="promise_in_bounds").reshape(n_atoms, k3, grid_size)
    p3_rows = p3.reshape(-1, grid_size).at[flat].get(
        mode="promise_in_bounds").reshape(n_atoms, k3, grid_size)
    pv_rows = pv.reshape(-1, grid_size, 3).at[flat].get(
        mode="promise_in_bounds").reshape(n_atoms, k3, grid_size, 3)
    mask_f = nbr3_mask.astype(positions.dtype)
    nbr_term = (_einsum("akg,akx,ak->axg", p1_rows, unit, mask_f)
                + _einsum("akg,akx,ak->axg", p3_rows, d, mask_f)
                + _einsum("akgx,ak->axg", pv_rows, mask_f))
    # reference sign convention (angles.py:229-231 applies the minus to
    # the raw accumulation; the derivative identities here already
    # carry it)
    grid_forces = (grid_center.reshape(n_atoms, 3, grid_size)
                   + nbr_term)
    f3 = grid_forces.reshape(n_atoms, 3, l_dim, l_dim, nc)
    return e2, f2, e3, f3


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------
def build_featurize_spec(bspline_config):
    """Static device-featurization spec; None when the model shape is
    outside the fast path (multi-species or non-closed-form knots)."""
    from uf3_tpu.ops.pallas_trio import leg_spec_from_knots
    if bspline_config.degree != 3:
        return None
    if len(bspline_config.chemical_system.element_list) != 1:
        return None
    pair = bspline_config.interactions_map[2][0]
    trio = bspline_config.interactions_map[3][0]
    ok_p, spec_p = leg_spec_from_knots(
        bspline_config.knots_map[pair], exact=True)
    seqs = [np.asarray(s) for s in bspline_config.knots_map[trio]]
    if not np.array_equal(seqs[0], seqs[1]):
        return None
    ok_l, spec_l = leg_spec_from_knots(seqs[0], exact=True)
    ok_n, spec_n = leg_spec_from_knots(seqs[2], exact=True)
    if not (ok_p and ok_l and ok_n):
        return None
    return FeaturizeSpec(
        pair=spec_p,
        pair_lead=bspline_config.leading_trim[2],
        pair_trail=bspline_config.trailing_trim[2],
        trio_l=spec_l, trio_n=spec_n,
        trio_lead=bspline_config.leading_trim[3],
        trio_trail=bspline_config.trailing_trim[3],
        l_basis=len(seqs[0]) - 4,
        n_basis=len(seqs[2]) - 4)


def host_neighbor_arrays(geom, r_cut: float, capacity: int,
                         supercell=None, matrix=None,
                         with_rev: bool = True):
    """
    Exact (N, K) neighbor arrays (idx, shift, mask, rev) from the
    ghost-atom supercell -- works for arbitrarily small periodic
    cells (multiple images of the same neighbor appear as separate
    slots with distinct shifts).  ``supercell``/``matrix`` accept a
    precomputed ghost supercell and geom-vs-supercell distance matrix
    (the dominant host cost; _measured_neighbors reuses its own).
    ``with_rev=False`` skips the reverse-slot matching -- its
    (N, k, k, 3) candidate tensor dominates host prep at 2-body
    capacities, and only the 3-BODY list's rev is ever consumed by
    the device featurizers.
    """
    from uf3_tpu.data import geometry as geo
    n_atoms = len(geom)
    if supercell is None:
        if np.any(geom.get_pbc()):
            supercell = geo.get_supercell(geom, r_cut=r_cut)
        else:
            supercell = geom
    if matrix is None:
        matrix = geo.get_distance_matrix(geom, supercell)
    n_images = len(supercell) // n_atoms
    cell = geom.get_cell()
    # image offset of each supercell atom (integer lattice coordinates)
    image_positions = supercell.get_positions().reshape(n_images,
                                                        n_atoms, 3)
    offsets = image_positions - geom.get_positions()[None, :, :]
    image_shift = np.round(offsets[:, 0, :] @ np.linalg.pinv(cell)) \
        if np.any(geom.get_pbc()) else np.zeros((1, 3))
    within = (matrix > 1e-10) & (matrix < r_cut)
    counts = within.sum(axis=1)
    if counts.max() > capacity:
        raise ValueError(f"neighbor capacity {capacity} exceeded "
                         f"({counts.max()})")
    # vectorized pack: stable-sort valid columns to the front
    order = np.argsort(~within, axis=1, kind="stable")
    take = min(capacity, order.shape[1])
    order = order[:, :take]
    mask = np.take_along_axis(within, order, axis=1)
    if take < capacity:   # fewer candidate columns than capacity
        order = np.pad(order, ((0, 0), (0, capacity - take)))
        mask = np.pad(mask, ((0, 0), (0, capacity - take)))
    self_col = np.arange(n_atoms, dtype=np.int64)[:, None]
    idx = np.where(mask, order % n_atoms, self_col).astype(np.int32)
    shift = np.where(mask[:, :, None],
                     image_shift[order // n_atoms], 0.0)
    if not with_rev:
        return idx, shift, mask, np.zeros((n_atoms, capacity),
                                          dtype=np.int32)
    # reverse slots, vectorized: match (index, opposite image); work
    # on count-trimmed views -- at the generous capacities used for
    # shape bucketing the (N, K, K, 3) candidate tensor dominates
    kmax = max(1, int(counts.max()))
    idx_t = idx[:, :kmax]
    shift_t = shift[:, :kmax]
    mask_t = mask[:, :kmax]
    cand_idx = idx_t[idx_t]                   # (N, k, k)
    cand_shift = shift_t[idx_t]               # (N, k, k, 3)
    cand_mask = mask_t[idx_t]
    match = (cand_mask
             & (cand_idx == self_col[:, :, None])
             & np.all(cand_shift == -shift_t[:, :, None, :], axis=-1))
    rev = np.zeros((n_atoms, capacity), dtype=np.int32)
    rev[:, :kmax] = np.where(mask_t, np.argmax(match, axis=-1), 0)
    return idx, shift, mask, rev


def featurize_configuration_device(bspline_config, geom,
                                   spec: FeaturizeSpec = None,
                                   dtype=None):
    """
    Device-path equivalent of BasisFeaturizer.evaluate_configuration
    for unary 2+3-body systems: returns (energy feature vector without
    the target column, force feature array (N, 3, n_feats)).
    """
    import jax.numpy as jnp
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 \
            else jnp.float32
    if spec is None:
        spec = build_featurize_spec(bspline_config)
    if spec is None:
        raise ValueError("configuration outside the device fast path")
    n_atoms = len(geom)
    cap2 = 96
    cap3 = 48
    idx2, shift2, mask2, rev2 = host_neighbor_arrays(
        geom, spec.pair.t_max, cap2)
    idx3, shift3, mask3, rev3 = host_neighbor_arrays(
        geom, spec.trio_l.t_max, cap3)
    e2, f2, e3, f3 = featurize_device(
        spec,
        jnp.asarray(geom.get_positions(), dtype=dtype),
        jnp.asarray(geom.get_cell(), dtype=dtype),
        jnp.asarray(idx2), jnp.asarray(shift2, dtype=dtype),
        jnp.asarray(mask2), jnp.asarray(rev2),
        jnp.asarray(idx3), jnp.asarray(shift3, dtype=dtype),
        jnp.asarray(mask3), jnp.asarray(rev3))
    trio = bspline_config.interactions_map[3][0]
    e3_compressed = bspline_config.compress_3B(np.asarray(e3), trio)
    f3_compressed = bspline_config.compress_3B_batch(np.asarray(f3),
                                                     trio)
    counts = np.array([n_atoms], dtype=float)
    e_vector = np.concatenate([counts, np.asarray(e2), e3_compressed])
    f2_np = np.asarray(f2)
    f_vectors = np.concatenate([
        np.zeros((n_atoms, 3, 1)), f2_np, f3_compressed], axis=2)
    return e_vector, f_vectors


def _compression_arrays(bspline_config, dtype):
    """Static 3B compression data for the device path: (flat wedge
    indices into the L*M*NC grid, per-wedge weights, symmetry)."""
    trio = bspline_config.interactions_map[3][0]
    idx = np.asarray(bspline_config.template_mask[trio],
                     dtype=np.int32)
    weights = np.asarray(bspline_config.flat_weights[trio])
    return (jnp.asarray(idx),
            jnp.asarray(weights, dtype=dtype),
            int(bspline_config.symmetry[trio]))


def _compress_device(grid_flat, comp_idx, comp_w, symmetry,
                     l_dim, nc):
    """compress_3B on device: symmetrize + wedge selection + weights.
    grid_flat: (..., L * L * NC)."""
    lead = grid_flat.shape[:-1]
    g = grid_flat.reshape(lead + (l_dim, l_dim, nc))
    if symmetry == 2:
        g = g + jnp.swapaxes(g, -3, -2)
    elif symmetry == 3:
        perms = ((-3, -2, -1), (-3, -1, -2), (-2, -3, -1),
                 (-2, -1, -3), (-1, -3, -2), (-1, -2, -3))
        nd = g.ndim
        base = tuple(range(nd - 3))
        g = sum(jnp.transpose(g, base + tuple(nd + p for p in perm))
                for perm in perms)
    flat = g.reshape(lead + (-1,))
    return jnp.take(flat, comp_idx, axis=-1) * comp_w


@functools.partial(jax.jit,
                   static_argnames=("spec", "symmetry", "n_cfg"))
def _featurize_bucket(spec: FeaturizeSpec, symmetry: int, n_cfg: int,
                      comp_idx, comp_w,
                      positions, cells,
                      idx2, shift2, mask2, rev2,
                      idx3, shift3, mask3, rev3):
    """One jitted call featurizing a stacked shape bucket of n_cfg
    configurations (lax.map over the config axis rather than vmap,
    which would re-lower the HIGHEST-precision einsums as batched
    contractions) with on-device 3B compression, so one transfer
    round-trip serves the whole bucket."""
    l_dim, nc = spec.l_basis, spec.n_basis

    def one(args):
        (pos, cell, i2, s2, m2, r2, i3, s3, m3, r3) = args
        e2, f2, e3, f3 = featurize_device(spec, pos, cell, i2, s2,
                                          m2, r2, i3, s3, m3, r3)
        n_atoms = pos.shape[0]
        e3c = _compress_device(e3.reshape(-1), comp_idx, comp_w,
                               symmetry, l_dim, nc)
        f3c = _compress_device(f3.reshape(n_atoms, 3, -1), comp_idx,
                               comp_w, symmetry, l_dim, nc)
        return e2, f2, e3c, f3c

    return jax.lax.map(one, (positions, cells, idx2, shift2, mask2,
                             rev2, idx3, shift3, mask3, rev3))


def _bucket_capacity(count: int, granule: int = 8) -> int:
    """Round a measured neighbor count up to a shape-bucket granule
    (amortizes compilation across configs of similar size)."""
    return max(granule, -(-int(count) // granule) * granule)


@functools.partial(jax.jit,
                   static_argnames=("spec", "symmetry", "n_cfg",
                                    "images", "cap2", "cap3", "pbc"))
def _featurize_bucket_dev(spec: FeaturizeSpec, symmetry: int,
                          n_cfg: int, images, cap2: int, cap3: int,
                          pbc, comp_idx, comp_w, positions, cells):
    """Bucket featurization with ON-DEVICE neighbor construction:
    the host ships only (positions, cells); the explicit-image
    builder (exact for small periodic cells) runs inside the same
    launch as the featurizer, as O(N^2 M) elementwise work amortized
    across the lax.map, in place of the numpy supercell + cdist +
    pack pipeline on the host.

    Returns (e2, f2, e3c, f3c, overflow[n_cfg]); overflowed configs
    must be redone at larger capacity (the features are truncated)."""
    from uf3_tpu.ops import neighbors as nbops
    l_dim, nc = spec.l_basis, spec.n_basis

    def one(args):
        pos, cell = args
        nbr2 = nbops.build_neighbor_list_images(
            pos, cell, pbc, spec.pair.t_max, cap2, images=images,
            with_rev=False)
        nbr3 = nbops.build_neighbor_list_images(
            pos, cell, pbc, spec.trio_l.t_max, cap3, images=images,
            with_rev=True)
        e2, f2, e3, f3 = featurize_device(
            spec, pos, cell, nbr2.idx, nbr2.shift, nbr2.mask,
            nbr2.rev, nbr3.idx, nbr3.shift, nbr3.mask, nbr3.rev)
        n_atoms = pos.shape[0]
        e3c = _compress_device(e3.reshape(-1), comp_idx, comp_w,
                               symmetry, l_dim, nc)
        f3c = _compress_device(f3.reshape(n_atoms, 3, -1), comp_idx,
                               comp_w, symmetry, l_dim, nc)
        return e2, f2, e3c, f3c, nbr2.overflow | nbr3.overflow

    return jax.lax.map(one, (positions, cells))


def featurize_dataset_device(bspline_config,
                             geometries,
                             energies,
                             forces,
                             dtype=None,
                             progress=None,
                             batch_size: int = 32,
                             neighbors: str = "device"):
    """
    Device featurization of a dataset into fitting arrays
    (x_e, y_e, x_f, y_f) with per-atom energy normalization, matching
    regression.least_squares.dataframe_to_tuples semantics.

    Configurations are grouped into shape buckets and each bucket is
    featurized in one jitted device call (stacked arrays, lax.map
    over configs, on-device 3B compression).  This amortizes both
    compilation and the host<->device transfer latency that dominated
    the per-config path.  Force rows are ordered fx_0..fx_{N-1},
    fy..., fz... per configuration, matching the host featurizer row
    order.

    ``neighbors="device"`` (default) also builds the neighbor lists
    inside the bucket launch (explicit-image device builder, exact
    for small cells) at density-estimated capacities -- the host
    ships only positions + cells, instead of running the numpy
    supercell/cdist/pack pipeline per config.  Configs whose
    estimated capacity overflows are redone through the measured
    host path ("host": always use that path).
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 \
            else jnp.float32
    spec = build_featurize_spec(bspline_config)
    if spec is None:
        raise ValueError("dataset outside the device fast path")
    comp_idx, comp_w, symmetry = _compression_arrays(bspline_config,
                                                     dtype)
    n_total = len(geometries)
    e_vecs = [None] * n_total
    f_vecs = [None] * n_total
    done = 0
    host_entries = []   # (geom, i): measured-capacity host-prep path

    if neighbors == "device":
        from uf3_tpu.ops import neighbors as nbops
        buckets = {}
        for i, geom in enumerate(geometries):
            n_atoms = len(geom)
            pbc = tuple(bool(p) for p in geom.get_pbc())
            cell = np.asarray(geom.get_cell())
            if not any(pbc):
                host_entries.append((geom, i))
                continue
            req = nbops.images_required(cell, pbc, spec.pair.t_max)
            images = tuple(max(1, r) if p else 0
                           for r, p in zip(req, pbc))
            volume = abs(np.linalg.det(cell))
            cap2 = _bucket_capacity(nbops.estimate_capacity(
                n_atoms, volume, spec.pair.t_max))
            cap3 = _bucket_capacity(nbops.estimate_capacity(
                n_atoms, volume, spec.trio_l.t_max))
            buckets.setdefault((n_atoms, images, pbc, cap2, cap3),
                               []).append((geom, i))
            if progress is not None:
                progress(i + 1, 2 * n_total)
        for (n_atoms, images, pbc, cap2, cap3), entries \
                in buckets.items():
            for start in range(0, len(entries), batch_size):
                chunk = entries[start:start + batch_size]
                geoms_np = np.stack([np.asarray(g.get_positions())
                                     for g, _ in chunk])
                cells_np = np.stack([np.asarray(g.get_cell())
                                     for g, _ in chunk])
                # pad remainder chunks up to batch_size by repeating
                # the first config (results discarded): every bucket
                # then compiles exactly ONE batch shape -- ~10 s of
                # XLA compile per distinct shape dwarfs the wasted
                # device work
                n_real = len(chunk)
                if 1 < n_real < batch_size \
                        and len(entries) > batch_size:
                    pad_n = batch_size - n_real
                    geoms_np = np.concatenate(
                        [geoms_np, np.repeat(geoms_np[:1], pad_n,
                                             axis=0)])
                    cells_np = np.concatenate(
                        [cells_np, np.repeat(cells_np[:1], pad_n,
                                             axis=0)])
                e2, f2, e3c, f3c, over = _featurize_bucket_dev(
                    spec, symmetry, len(geoms_np), images, cap2, cap3,
                    pbc, comp_idx, comp_w,
                    jnp.asarray(geoms_np, dtype=dtype),
                    jnp.asarray(cells_np, dtype=dtype))
                over = np.asarray(over)
                e2 = np.asarray(e2)
                f2 = np.asarray(f2)
                e3c = np.asarray(e3c)
                f3c = np.asarray(f3c)
                for b, (geom, i) in enumerate(chunk):
                    if over[b]:
                        # estimated capacity truncated this config:
                        # redo it at measured capacity
                        host_entries.append((geom, i))
                        continue
                    counts = np.array([n_atoms], dtype=float)
                    e_vecs[i] = np.concatenate([counts, e2[b],
                                                e3c[b]])
                    f_vecs[i] = np.concatenate(
                        [np.zeros((n_atoms, 3, 1)), f2[b], f3c[b]],
                        axis=2)
                    done += 1
                    if progress is not None:
                        progress(n_total + done, 2 * n_total)
    else:
        host_entries = [(geom, i)
                        for i, geom in enumerate(geometries)]

    # host-prep path: measured capacities (exact, never truncates)
    prepared = []
    for geom, i in host_entries:
        # one supercell + distance matrix at the larger (2-body)
        # cutoff serves both lists; the 2-body rev is never consumed
        # by featurize_device, so skip its (N, k, k, 3) matching
        from uf3_tpu.data import geometry as geo
        if np.any(geom.get_pbc()):
            supercell = geo.get_supercell(geom, r_cut=spec.pair.t_max)
        else:
            supercell = geom
        matrix = geo.get_distance_matrix(geom, supercell)
        idx2, shift2, mask2, rev2, cap2 = _measured_neighbors(
            geom, spec.pair.t_max, with_rev=False,
            supercell=supercell, matrix=matrix)
        idx3, shift3, mask3, rev3, cap3 = _measured_neighbors(
            geom, spec.trio_l.t_max, supercell=supercell,
            matrix=matrix)
        prepared.append((len(geom), cap2, cap3,
                         (geom, idx2, shift2, mask2, rev2,
                          idx3, shift3, mask3, rev3), i))
    buckets = {}
    for n_atoms, cap2, cap3, arrays, i in prepared:
        buckets.setdefault((n_atoms, cap2, cap3),
                           []).append((arrays, i))
    for (n_atoms, cap2, cap3), entries in buckets.items():
        for start in range(0, len(entries), batch_size):
            chunk = entries[start:start + batch_size]
            stacked = [None]
            for j in range(1, 9):
                stacked.append(np.stack([c[0][j] for c in chunk]))
            geoms_np = np.stack([np.asarray(
                c[0][0].get_positions()) for c in chunk])
            cells_np = np.stack([np.asarray(c[0][0].get_cell())
                                 for c in chunk])
            e2, f2, e3c, f3c = _featurize_bucket(
                spec, symmetry, len(chunk), comp_idx, comp_w,
                jnp.asarray(geoms_np, dtype=dtype),
                jnp.asarray(cells_np, dtype=dtype),
                jnp.asarray(stacked[1]),
                jnp.asarray(stacked[2], dtype=dtype),
                jnp.asarray(stacked[3]), jnp.asarray(stacked[4]),
                jnp.asarray(stacked[5]),
                jnp.asarray(stacked[6], dtype=dtype),
                jnp.asarray(stacked[7]), jnp.asarray(stacked[8]))
            e2 = np.asarray(e2)
            f2 = np.asarray(f2)
            e3c = np.asarray(e3c)
            f3c = np.asarray(f3c)
            for b, (arrays, i) in enumerate(chunk):
                counts = np.array([n_atoms], dtype=float)
                e_vecs[i] = np.concatenate([counts, e2[b], e3c[b]])
                f_vecs[i] = np.concatenate(
                    [np.zeros((n_atoms, 3, 1)), f2[b], f3c[b]],
                    axis=2)
                done += 1
                if progress is not None:
                    progress(n_total + done, 2 * n_total)
    x_e, y_e, x_f, y_f = [], [], [], []
    for i, (geom, energy, force) in enumerate(
            zip(geometries, energies, forces)):
        n_atoms = len(geom)
        x_e.append(e_vecs[i] / n_atoms)
        y_e.append(energy / n_atoms)
        force = np.asarray(force)
        if force.shape[0] != 3:
            force = force.T
        x_f.append(f_vecs[i].transpose(1, 0, 2).reshape(3 * n_atoms,
                                                        -1))
        y_f.append(force.reshape(-1))
    return (np.stack(x_e), np.asarray(y_e),
            np.concatenate(x_f, axis=0), np.concatenate(y_f))


# ---------------------------------------------------------------------------
# multi-species device featurization
# ---------------------------------------------------------------------------
class PairBlock(NamedTuple):
    """Static per-pair-interaction description (species-gated)."""
    spec: LegSpec
    lead: int
    trail: int
    s_a: int
    s_b: int
    n_basis: int


class TrioBlock(NamedTuple):
    """Static per-trio-interaction description.  The m leg (grid axis
    0, knots_map[trio][0]) binds the LOWER-atomic-number neighbor
    species, matching the oracle's z-ordering of neighbor pairs
    (featurize_np.enumerate_triplets; reference angles.py:424-478)."""
    spec_l1: LegSpec         # center - m leg
    spec_l2: LegSpec         # center - n leg
    spec_n: LegSpec          # m - n (third) leg
    lead: int
    trail: int
    s_c: int
    s_m: int
    s_n: int
    l1_basis: int
    l2_basis: int
    n_basis: int
    weight: float            # 0.5 when s_m == s_n (ordered pairs
    #                          double-count), else 1.0


class MultiFeaturizeSpec(NamedTuple):
    pairs: Tuple             # tuple of PairBlock, interactions order
    trios: Tuple             # tuple of TrioBlock, interactions order
    n_elements: int


def build_featurize_spec_multi(bspline_config):
    """Static multi-species device-featurization spec; None when any
    knot sequence lacks a closed-form LegSpec."""
    from uf3_tpu.data import elements
    from uf3_tpu.ops.pallas_trio import leg_spec_from_knots
    config = bspline_config
    element_list = list(config.chemical_system.element_list)
    s_of = {el: i for i, el in enumerate(element_list)}
    pairs = []
    for pair in config.interactions_map[2]:
        ok, spec = leg_spec_from_knots(config.knots_map[pair],
                                       exact=True)
        if not ok:
            return None
        pairs.append(PairBlock(
            spec=spec, lead=config.leading_trim[2],
            trail=config.trailing_trim[2],
            s_a=s_of[pair[0]], s_b=s_of[pair[1]],
            n_basis=spec.n_basis))
    trios = []
    if config.degree > 2:
        for trio in config.interactions_map[3]:
            seqs = [np.asarray(s) for s in config.knots_map[trio]]
            specs = []
            for seq in seqs:
                ok, spec = leg_spec_from_knots(seq, exact=True)
                if not ok:
                    return None
                specs.append(spec)
            el_m, el_n = trio[1], trio[2]
            if elements.atomic_numbers[el_m] \
                    > elements.atomic_numbers[el_n]:
                el_m, el_n = el_n, el_m
            trios.append(TrioBlock(
                spec_l1=specs[0], spec_l2=specs[1], spec_n=specs[2],
                lead=config.leading_trim[3],
                trail=config.trailing_trim[3],
                s_c=s_of[trio[0]], s_m=s_of[el_m], s_n=s_of[el_n],
                l1_basis=len(seqs[0]) - 4,
                l2_basis=len(seqs[1]) - 4,
                n_basis=len(seqs[2]) - 4,
                weight=0.5 if el_m == el_n else 1.0))
    return MultiFeaturizeSpec(pairs=tuple(pairs), trios=tuple(trios),
                              n_elements=len(element_list))


def _trio_block_grids(tb: TrioBlock, d, r, r_mn, r_mn2, unit,
                      mask3, s_c_row, s_slot3, flat_rev, n_atoms, k3):
    """Energy grid + force grids for one trio interaction.  Both
    derivative chains (m leg and n leg) are explicit because
    heterogeneous trios are single-counted: an atom of species s_m
    only ever occupies the m role (the unary path recovers the n
    chain from the ordered-pair double count instead)."""
    gate_c = s_c_row == tb.s_c
    mask_m = mask3 & (s_slot3 == tb.s_m) & gate_c[:, None]
    mask_n = mask3 & (s_slot3 == tb.s_n) & gate_c[:, None]
    a1, da1 = _trimmed_basis(r, mask_m, tb.spec_l1, tb.lead, tb.trail)
    a2, da2 = _trimmed_basis(r, mask_n, tb.spec_l2, tb.lead, tb.trail)
    pair_ok = mask_m[:, :, None] & mask_n[:, None, :] & (r_mn2 > 1e-10)
    c_mat, dc_mat = _trimmed_basis(r_mn, pair_ok, tb.spec_n, tb.lead,
                                   tb.trail)
    dc_over_r = dc_mat / r_mn[..., None]
    # m chain: contract the n role first
    q0 = _einsum("cnb,cmnw->cmbw", a2, c_mat)
    q3m = _einsum("cnb,cmnw->cmbw", a2, dc_over_r)
    qvm = _einsum("cnb,cmnw,cnx->cmbwx", a2, dc_over_r, d)
    p0 = _einsum("cma,cmbw->cmabw", a1, q0)
    p1m = _einsum("cma,cmbw->cmabw", da1, q0)
    p3m = _einsum("cma,cmbw->cmabw", a1, q3m)
    pvm = _einsum("cma,cmbwx->cmabwx", a1, qvm)
    # n chain: contract the m role first
    q0n = _einsum("cma,cmnw->cnaw", a1, c_mat)
    q3n = _einsum("cma,cmnw->cnaw", a1, dc_over_r)
    qvn = _einsum("cma,cmnw,cmx->cnawx", a1, dc_over_r, d)
    p1n = _einsum("cnb,cnaw->cnabw", da2, q0n)
    p3n = _einsum("cnb,cnaw->cnabw", a2, q3n)
    pvn = _einsum("cnb,cnawx->cnabwx", a2, qvn)
    e3 = tb.weight * jnp.sum(p0, axis=(0, 1))
    center = (_einsum("cmabw,cmx->cxabw", p1m, unit)
              + _einsum("cnabw,cnx->cxabw", p1n, unit))
    grid_size = tb.l1_basis * tb.l2_basis * tb.n_basis

    def rows(p):
        return p.reshape(-1, grid_size).at[flat_rev].get(
            mode="promise_in_bounds").reshape(n_atoms, k3, grid_size)

    def rows_v(p):
        return p.reshape(-1, grid_size, 3).at[flat_rev].get(
            mode="promise_in_bounds").reshape(n_atoms, k3, grid_size,
                                              3)

    mask_f = mask3.astype(d.dtype)
    nbr = jnp.zeros((n_atoms, 3, grid_size), dtype=d.dtype)
    for p1x, p3x, pvx in ((p1m, p3m, pvm), (p1n, p3n, pvn)):
        nbr = nbr + (
            _einsum("akg,akx,ak->axg", rows(p1x), unit, mask_f)
            + _einsum("akg,akx,ak->axg", rows(p3x), d, mask_f)
            + _einsum("akgx,ak->axg", rows_v(pvx), mask_f))
    forces = tb.weight * (center.reshape(n_atoms, 3, grid_size) + nbr)
    shape = (tb.l1_basis, tb.l2_basis, tb.n_basis)
    return e3, forces.reshape((n_atoms, 3) + shape)


@functools.partial(jax.jit, static_argnames=("mspec",))
def featurize_device_multi(mspec: MultiFeaturizeSpec,
                           species, positions, cell,
                           nbr_idx, nbr_shift, nbr_mask, nbr_rev,
                           nbr3_idx, nbr3_shift, nbr3_mask, nbr3_rev):
    """
    Energy + force features for one multi-species configuration:
    species-gated masks over shared neighbor geometry, one pass per
    interaction (the per-type loop is static/unrolled).

    Returns (e2_blocks, f2_blocks, e3_grids, f3_grids) -- tuples in
    interactions_map order; 3B grids uncompressed (L1, L2, NC).
    """
    n_atoms = positions.shape[0]
    s = species.astype(jnp.int32)
    # ---- 2-body ----
    d2v = (positions[nbr_idx] + cell_transform(nbr_shift, cell)
           - positions[:, None, :])
    r2sq = jnp.sum(d2v * d2v, axis=-1)
    r2 = jnp.sqrt(jnp.where(r2sq > 0, r2sq, 1.0))
    unit2 = d2v / r2[..., None]
    s_slot2 = jnp.take(s, nbr_idx)
    e2_blocks, f2_blocks = [], []
    for pb in mspec.pairs:
        gate = (((s[:, None] == pb.s_a) & (s_slot2 == pb.s_b))
                | ((s[:, None] == pb.s_b) & (s_slot2 == pb.s_a)))
        valid_p = (nbr_mask & gate & (r2 > pb.spec.t_min)
                   & (r2 < pb.spec.t_max))
        a2, da2 = _trimmed_basis(r2, valid_p, pb.spec, pb.lead,
                                 pb.trail)
        e2_blocks.append(jnp.sum(a2, axis=(0, 1)))
        f2_blocks.append(2.0 * _einsum("nks,nkc->ncs", da2, unit2))
    # ---- 3-body ----
    e3_grids, f3_grids = [], []
    if mspec.trios:
        k3 = nbr3_idx.shape[1]
        d = (positions[nbr3_idx] + cell_transform(nbr3_shift, cell)
             - positions[:, None, :])
        rsq = jnp.sum(d * d, axis=-1)
        r = jnp.sqrt(jnp.where(rsq > 0, rsq, 1.0))
        unit = d / r[..., None]
        d_mn = d[:, None, :, :] - d[:, :, None, :]
        r_mn2 = jnp.sum(d_mn * d_mn, axis=-1)
        r_mn = jnp.sqrt(jnp.where(r_mn2 > 0, r_mn2, 1.0))
        s_slot3 = jnp.take(s, nbr3_idx)
        flat_rev = (nbr3_idx.astype(jnp.int32) * k3
                    + nbr3_rev.astype(jnp.int32)).reshape(-1)
        for tb in mspec.trios:
            e3, f3 = _trio_block_grids(
                tb, d, r, r_mn, r_mn2, unit, nbr3_mask, s, s_slot3,
                flat_rev, n_atoms, k3)
            e3_grids.append(e3)
            f3_grids.append(f3)
    return (tuple(e2_blocks), tuple(f2_blocks), tuple(e3_grids),
            tuple(f3_grids))


def featurize_configuration_device_multi(bspline_config, geom,
                                         mspec: MultiFeaturizeSpec
                                         = None,
                                         dtype=None):
    """
    Multi-species device equivalent of
    BasisFeaturizer.evaluate_configuration: returns (energy feature
    vector without the target column, force features (N, 3, n_feats)).
    """
    from uf3_tpu.data import elements as el_mod
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 \
            else jnp.float32
    if mspec is None:
        mspec = build_featurize_spec_multi(bspline_config)
    if mspec is None:
        raise ValueError("configuration outside the device fast path")
    config = bspline_config
    element_list = list(config.chemical_system.element_list)
    s_of = {el_mod.atomic_numbers[el]: i
            for i, el in enumerate(element_list)}
    species = np.array([s_of[z] for z in geom.get_atomic_numbers()],
                       dtype=np.int32)
    n_atoms = len(geom)
    r2_max = max(pb.spec.t_max for pb in mspec.pairs)
    idx2, shift2, mask2, rev2 = host_neighbor_arrays(geom, r2_max, 96)
    if mspec.trios:
        r3_max = max(max(tb.spec_l1.t_max, tb.spec_l2.t_max)
                     for tb in mspec.trios)
        idx3, shift3, mask3, rev3 = host_neighbor_arrays(geom, r3_max,
                                                         48)
    else:
        idx3 = np.zeros((n_atoms, 1), dtype=np.int32)
        shift3 = np.zeros((n_atoms, 1, 3))
        mask3 = np.zeros((n_atoms, 1), dtype=bool)
        rev3 = np.zeros((n_atoms, 1), dtype=np.int32)
    e2_b, f2_b, e3_g, f3_g = featurize_device_multi(
        mspec, jnp.asarray(species),
        jnp.asarray(geom.get_positions(), dtype=dtype),
        jnp.asarray(geom.get_cell(), dtype=dtype),
        jnp.asarray(idx2), jnp.asarray(shift2, dtype=dtype),
        jnp.asarray(mask2), jnp.asarray(rev2),
        jnp.asarray(idx3), jnp.asarray(shift3, dtype=dtype),
        jnp.asarray(mask3), jnp.asarray(rev3))
    counts = np.array([np.sum(species == i)
                       for i in range(mspec.n_elements)], dtype=float)
    e_parts = [counts] + [np.asarray(b) for b in e2_b]
    f_parts = [np.zeros((n_atoms, 3, mspec.n_elements))] \
        + [np.asarray(b) for b in f2_b]
    for t, trio in enumerate(config.interactions_map[3]
                             if config.degree > 2 else []):
        e_parts.append(config.compress_3B(np.asarray(e3_g[t]), trio))
        f_parts.append(config.compress_3B_batch(np.asarray(f3_g[t]),
                                                trio))
    return np.concatenate(e_parts), np.concatenate(f_parts, axis=2)


def _measured_neighbors(geom, r_cut: float, granule: int = 8,
                        with_rev: bool = True,
                        supercell=None, matrix=None):
    """host_neighbor_arrays at a capacity measured from the actual
    max neighbor count, rounded up to a shape-bucket granule.
    ``supercell``/``matrix`` reuse a larger-cutoff prep (the 3-body
    supercell is a subset of the 2-body one)."""
    from uf3_tpu.data import geometry as geo
    if supercell is None:
        if np.any(geom.get_pbc()):
            supercell = geo.get_supercell(geom, r_cut=r_cut)
        else:
            supercell = geom
    if matrix is None:
        matrix = geo.get_distance_matrix(geom, supercell)
    counts = ((matrix > 1e-10) & (matrix < r_cut)).sum(axis=1)
    cap = _bucket_capacity(int(counts.max()), granule)
    idx, shift, mask, rev = host_neighbor_arrays(
        geom, r_cut, cap, supercell=supercell, matrix=matrix,
        with_rev=with_rev)
    return idx, shift, mask, rev, cap
