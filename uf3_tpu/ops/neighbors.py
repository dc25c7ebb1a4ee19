"""
Fixed-capacity padded neighbor lists on device (JAX).

Minimum-image convention with integer image shifts; valid for cells whose
perpendicular widths exceed twice the cutoff (the MD regime).  Small
periodic cells -- training configurations -- go through the host
ghost-atom path (uf3_tpu/data/geometry.py) instead.  Replaces the
reference's dense scipy cdist + ragged masking (uf3/representation/
distances.py) with fixed shapes: (N, K) neighbor indices + shifts + mask,
plus an inverse-slot map used by the scatter-free 3-body force kernel.
"""

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class NeighborList(NamedTuple):
    idx: jnp.ndarray        # (N, K) int32 neighbor indices (self-padded)
    shift: jnp.ndarray      # (N, K, 3) image shifts (float, integer-valued)
    mask: jnp.ndarray       # (N, K) bool
    rev: jnp.ndarray        # (N, K) int32: slot of atom i in neighbor's list
    overflow: jnp.ndarray   # () bool: capacity exceeded
    reference_positions: jnp.ndarray  # (N, 3) positions at build time
    sel: jnp.ndarray = None  # (N, K) int32 parent-list slot ids when this
    #   list was derived by filter_neighbor_list: slot k of this list is
    #   slot sel[a, k] of the parent 2-body list, letting the MD step
    #   reuse the parent's gathered displacements instead of re-gathering


def cell_transform(vecs, cell):
    """``vecs @ cell`` decomposed into elementwise mul-adds.  A
    reduced-precision matmul (bf16 inputs, ~2^-8 relative; or TF32,
    ~2^-11, the GPU's default for f32 dots) on cell vectors is a
    0.01-0.05 A displacement error -- fatal for forces.  Three
    mul-adds keep full working precision whatever the backend's
    matmul precision."""
    return (vecs[..., 0:1] * cell[0] + vecs[..., 1:2] * cell[1]
            + vecs[..., 2:3] * cell[2])


def displacements(positions, cell, idx, shift):
    """d[i, k] = R_idx[i,k] + shift[i,k] @ cell - R_i."""
    return (gather_rows(positions, idx) + cell_transform(shift, cell)
            - positions[:, None, :])


def gather_rows(table, idx):
    """table (N, D) gathered at idx (N, K) -> (N, K, D), as K per-column
    row takes: each take is a plain row gather, and no intermediate
    (N*K, D) index layout is built.  Whether this beats the one-shot
    2D gather on the GPU is not measured yet."""
    cols = [table.at[idx[:, k]].get(mode="promise_in_bounds")
            for k in range(idx.shape[1])]
    return jnp.stack(cols, axis=1)


def build_neighbor_list(positions: jnp.ndarray,
                        cell: jnp.ndarray,
                        pbc,
                        r_cut: float,
                        capacity: int,
                        block_size: int = 512,
                        with_rev: bool = True) -> NeighborList:
    """
    O(N^2) minimum-image neighbor search with per-row top-k selection,
    processed in row blocks to bound memory.  jit-compatible.
    """
    n_atoms = positions.shape[0]
    capacity = min(capacity, n_atoms)
    pbc_vec = jnp.asarray(pbc, dtype=positions.dtype).reshape(3)
    # callers pass an invertible cell (use a bounding box for molecules)
    frac = cell_transform(positions, jnp.linalg.inv(cell))
    r_cut2 = jnp.asarray(r_cut * r_cut, dtype=positions.dtype)

    n_blocks = -(-n_atoms // block_size)
    pad = n_blocks * block_size - n_atoms
    frac_padded = jnp.pad(frac, ((0, pad), (0, 0)))

    def process_block(block_frac):
        # block_frac: (B, 3).  The O(N^2) pass materializes ONLY the
        # (B, N) squared-distance plane (per-component accumulation in
        # registers); image shifts are recomputed afterwards for just
        # the top-k selected pairs -- materializing (B, N, 3) image
        # planes costs ~5x the whole selection
        mic = [None] * 3
        for c in range(3):
            dc = frac[:, c][None, :] - block_frac[:, c][:, None]
            mic[c] = dc - jnp.round(dc) * pbc_vec[c]
        d2 = jnp.zeros_like(mic[0])
        for k in range(3):
            dk = (mic[0] * cell[0, k] + mic[1] * cell[1, k]
                  + mic[2] * cell[2, k])
            d2 = d2 + dk * dk
        within = (d2 < r_cut2) & (d2 > 1e-12)
        count = jnp.sum(within, axis=1)
        # nearest-first: overflow drops the farthest pairs, and the
        # order-preserving downstream filter keeps the nearest subset
        key = jnp.where(within, -d2, -jnp.inf)
        neg, idx = jax.lax.top_k(key, capacity)  # (B, K)
        mask = neg > -jnp.inf
        # recompute the image shift for the selected pairs only (same
        # inputs, same rounding op -> bitwise-identical to the full
        # plane)
        sel = jnp.take(frac, idx.reshape(-1),
                       axis=0).reshape(idx.shape + (3,))
        diff_sel = sel - block_frac[:, None, :]
        shift = -jnp.round(diff_sel) * pbc_vec
        return idx, shift, mask, count

    blocks = frac_padded.reshape(n_blocks, block_size, 3)
    idx_b, shift_b, mask_b, count_b = jax.lax.map(process_block, blocks)
    idx = idx_b.reshape(-1, capacity)[:n_atoms].astype(jnp.int32)
    shift = shift_b.reshape(-1, capacity, 3)[:n_atoms]
    mask = mask_b.reshape(-1, capacity)[:n_atoms]
    count = count_b.reshape(-1)[:n_atoms]
    overflow = jnp.any(count > capacity)
    # self-pad invalid slots (zero displacement, masked out)
    self_idx = jnp.arange(n_atoms, dtype=jnp.int32)[:, None]
    idx = jnp.where(mask, idx, self_idx)
    shift = jnp.where(mask[:, :, None], shift, 0.0)
    rev = _reverse_slots(idx, shift, mask) if with_rev \
        else jnp.zeros_like(idx)
    return NeighborList(idx=idx, shift=shift, mask=mask, rev=rev,
                        overflow=overflow,
                        reference_positions=positions)


def build_neighbor_list_images(positions: jnp.ndarray,
                               cell: jnp.ndarray,
                               pbc,
                               r_cut: float,
                               capacity: int,
                               images: Tuple[int, int, int] = (1, 1, 1),
                               block_size: int = 512,
                               with_rev: bool = True) -> NeighborList:
    """
    O(N^2 * M) neighbor search with an explicit static image range --
    exact for small periodic cells where the cutoff exceeds half the
    cell width (including self-image pairs), where the minimum-image
    builder would silently drop pairs.  ``images[i]`` is the number of
    periodic copies scanned per direction along axis i.
    """
    n_atoms = positions.shape[0]
    ni = [int(images[i]) if pbc[i] else 0 for i in range(3)]
    grid = np.stack(np.meshgrid(
        np.arange(-ni[0], ni[0] + 1), np.arange(-ni[1], ni[1] + 1),
        np.arange(-ni[2], ni[2] + 1), indexing="ij"),
        axis=-1).reshape(-1, 3)
    shifts = jnp.asarray(grid, dtype=positions.dtype)  # (M, 3)
    n_images = shifts.shape[0]
    capacity = min(capacity, n_atoms * n_images)
    r_cut2 = jnp.asarray(r_cut * r_cut, dtype=positions.dtype)
    # explicit image copies: candidate c = j * M + m at R_j + S_m @ cell
    pos_ext = (positions[:, None, :]
               + cell_transform(shifts, cell)[None, :, :]).reshape(-1, 3)

    n_blocks = -(-n_atoms // block_size)
    pad = n_blocks * block_size - n_atoms
    pos_padded = jnp.pad(positions, ((0, pad), (0, 0)))

    def process_block(block_pos):
        # per-component (B, NM) arithmetic (atom axis on lanes)
        d2 = jnp.zeros((block_pos.shape[0], pos_ext.shape[0]),
                       dtype=positions.dtype)
        for c in range(3):
            dc = pos_ext[:, c][None, :] - block_pos[:, c][:, None]
            d2 = d2 + dc * dc
        within = (d2 < r_cut2) & (d2 > 1e-12)
        count = jnp.sum(within, axis=1)
        # nearest-first (see build_neighbor_list)
        key = jnp.where(within, -d2, -jnp.inf)
        neg, cand = jax.lax.top_k(key, capacity)
        mask = neg > -jnp.inf
        idx = cand // n_images
        shift = shifts[cand % n_images]
        return idx, shift, mask, count

    blocks = pos_padded.reshape(n_blocks, block_size, 3)
    idx_b, shift_b, mask_b, count_b = jax.lax.map(process_block, blocks)
    idx = idx_b.reshape(-1, capacity)[:n_atoms].astype(jnp.int32)
    shift = shift_b.reshape(-1, capacity, 3)[:n_atoms]
    mask = mask_b.reshape(-1, capacity)[:n_atoms]
    count = count_b.reshape(-1)[:n_atoms]
    overflow = jnp.any(count > capacity)
    self_idx = jnp.arange(n_atoms, dtype=jnp.int32)[:, None]
    idx = jnp.where(mask, idx, self_idx)
    shift = jnp.where(mask[:, :, None], shift, 0.0)
    rev = _reverse_slots(idx, shift, mask) if with_rev \
        else jnp.zeros_like(idx)
    return NeighborList(idx=idx, shift=shift, mask=mask, rev=rev,
                        overflow=overflow,
                        reference_positions=positions)


def images_required(cell, pbc, r_cut: float) -> Tuple[int, int, int]:
    """Periodic image copies per axis needed for an exact neighbor
    search at ``r_cut``: 0 means the minimum-image convention is valid
    (perpendicular cell width >= 2 * r_cut)."""
    cell = np.asarray(cell, dtype=np.float64)
    volume = abs(np.linalg.det(cell))
    out = []
    for i in range(3):
        if not pbc[i]:
            out.append(0)
            continue
        area = np.linalg.norm(np.cross(cell[(i + 1) % 3],
                                       cell[(i + 2) % 3]))
        width = volume / area
        out.append(0 if width >= 2.0 * r_cut
                   else int(np.ceil(r_cut / width)))
    return tuple(out)


def filter_neighbor_list(nbr: NeighborList, positions, cell,
                         r_cut: float, capacity: int,
                         with_rev: bool = True,
                         reference_positions=None) -> NeighborList:
    """Derive a smaller-cutoff list from an existing one (the 3-body
    list is a subset of the 2-body list): per-row top-k over the parent
    capacity instead of a fresh O(N^2) or cell search.

    ``reference_positions`` overrides the staleness reference of the
    derived list (pass the current positions when re-filtering mid-run
    with a fresher snapshot than the parent's build positions)."""
    n_atoms = nbr.idx.shape[0]
    # per-column row takes, then per-component (N, P) arithmetic
    pj = gather_rows(positions, nbr.idx)
    d2 = jnp.zeros(nbr.idx.shape, dtype=positions.dtype)
    for k in range(3):
        dk = (pj[..., k]
              + nbr.shift[..., 0] * cell[0, k]
              + nbr.shift[..., 1] * cell[1, k]
              + nbr.shift[..., 2] * cell[2, k]
              - positions[:, k][:, None])
        d2 = d2 + dk * dk
    within = nbr.mask & (d2 < r_cut * r_cut)
    count = jnp.sum(within, axis=1)
    overflow = nbr.overflow | jnp.any(count > capacity)
    # order-preserving prefix-sum pack: extract only the parent LANE
    # index per output slot (capacity masked reductions over the
    # (N, P) int32 plane -- exact, no sort, no matmul rounding), then
    # one take_along_axis per field instead of materializing an
    # (N, P, C) one-hot and contracting it five times
    slot = jnp.cumsum(within.astype(jnp.int32), axis=1) - 1
    parent_cap = nbr.idx.shape[1]
    lane = jnp.arange(parent_cap, dtype=jnp.int32)[None, :]
    sel = jnp.stack(
        [jnp.sum(jnp.where(within & (slot == s), lane, 0), axis=1)
         for s in range(capacity)], axis=-1)           # (N, C)
    mask = (jnp.arange(capacity, dtype=jnp.int32)[None, :]
            < count[:, None])
    sel = jnp.where(mask, sel, 0)
    idx = jnp.take_along_axis(nbr.idx, sel, axis=1)
    shift = jnp.take_along_axis(nbr.shift, sel[:, :, None], axis=1)
    self_idx = jnp.arange(n_atoms, dtype=jnp.int32)[:, None]
    idx = jnp.where(mask, idx, self_idx)
    shift = jnp.where(mask[:, :, None], shift, 0.0)
    rev = _reverse_slots(idx, shift, mask) if with_rev \
        else jnp.zeros_like(idx)
    if reference_positions is None:
        reference_positions = nbr.reference_positions
    return NeighborList(idx=idx, shift=shift, mask=mask, rev=rev,
                        overflow=overflow,
                        reference_positions=reference_positions,
                        sel=sel)


def _reverse_slots(idx, shift, mask):
    """
    rev[a, s] = slot s' such that idx[c, s'] == a with the opposite
    image shift, where c = idx[a, s].  Every true neighbor pair appears
    in both lists (the search is symmetric), so a match always exists
    for valid slots; invalid slots map to 0.
    """
    n_atoms, capacity = idx.shape
    c = idx  # (N, K)
    cand_idx = gather_rows(idx, c)   # (N, K, K): neighbors' lists
    cand_shift = gather_rows(
        shift.reshape(n_atoms, -1), c).reshape(
            n_atoms, capacity, capacity, 3)
    a = jnp.arange(n_atoms, dtype=idx.dtype)[:, None, None]
    match = (cand_idx == a) & jnp.all(
        cand_shift == -shift[:, :, None, :], axis=-1)
    rev = jnp.argmax(match, axis=-1).astype(jnp.int32)
    return jnp.where(mask, rev, 0)


def bin_topology(grid_shape, pbc):
    """
    Static 27-neighbor bin map: for every bin, the linear ids of its
    (up to) 27 neighbor bins and the integer image shift each crossing
    applies.  Bins repeat with different shifts when a direction has
    fewer than 3 bins (multi-image enumeration, exact for boxes down to
    one cutoff per direction).

    Returns (nbr_bins (B, 27) int32, nbr_shifts (B, 27, 3) float,
    valid (B, 27) bool) as numpy arrays (host, static).
    """
    nx, ny, nz = grid_shape
    n_bins = nx * ny * nz
    coords = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                  np.arange(nz), indexing="ij"),
                      axis=-1).reshape(-1, 3)
    offsets = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                   indexing="ij"), axis=-1).reshape(-1, 3)
    nbr_bins = np.zeros((n_bins, 27), dtype=np.int32)
    nbr_shifts = np.zeros((n_bins, 27, 3))
    valid = np.ones((n_bins, 27), dtype=bool)
    dims = np.array([nx, ny, nz])
    pbc_arr = np.asarray(pbc, dtype=bool)
    for o_idx, offset in enumerate(offsets):
        target = coords + offset
        shift = np.zeros_like(target, dtype=float)
        for d in range(3):
            below = target[:, d] < 0
            above = target[:, d] >= dims[d]
            if pbc_arr[d]:
                shift[below, d] = -1
                shift[above, d] = 1
                target[:, d] = target[:, d] % dims[d]
            else:
                valid[below | above, o_idx] = False
                target[:, d] = np.clip(target[:, d], 0, dims[d] - 1)
        nbr_bins[:, o_idx] = (target[:, 0] * ny + target[:, 1]) * nz \
            + target[:, 2]
        nbr_shifts[:, o_idx] = shift
    return nbr_bins, nbr_shifts, valid


def grid_shape_for(cell: np.ndarray, r_cut: float,
                   pbc) -> Tuple[int, int, int]:
    """Bins per direction: floor(perpendicular width / r_cut), >= 1."""
    cell = np.asarray(cell, dtype=np.float64)
    a, b, c = cell
    normals = [np.cross(b, c), np.cross(a, c), np.cross(a, b)]
    shape = []
    for v, n in zip((a, b, c), normals):
        width = abs(np.dot(v, n)) / max(np.linalg.norm(n), 1e-300)
        shape.append(max(1, int(np.floor(width / r_cut))))
    return tuple(shape)


def build_neighbor_list_cells(positions: jnp.ndarray,
                              cell: jnp.ndarray,
                              pbc,
                              r_cut: float,
                              capacity: int,
                              grid_shape: Tuple[int, int, int],
                              bin_capacity: int,
                              topology=None,
                              with_rev: bool = True,
                              assume_wrapped: bool = False,
                              selection: str = "pack2",
                              bin_block: int = None
                              ) -> NeighborList:
    """
    O(N) cell-list neighbor search, jit-compatible with static bin
    geometry: one argsort bins the atoms, candidates come from the 27
    neighbor bins via a static topology map, and the per-row selection
    runs over only 27 * bin_capacity candidates instead of all atoms.

    The selection is gather-free: the candidate's atom id and stencil
    shift code are packed into the low bits of an integer key, so the
    winners decode arithmetically -- no post-selection gathers over
    (B, cap_b, 27*cap_b) broadcasts, which dominated the build cost.

    ``selection`` picks how keys compact into the capacity slots:

    - ``"pack2"`` (default): two-stage order-preserving pack.  Stage 1
      packs each stencil group's ``cap_b`` candidate lanes locally
      (running count along the 32-lane group axis -- ``cap_b``
      lane-local extractions, no cross-group traffic); stage 2 places
      group g's survivors at the exclusive prefix offset of the
      per-group counts, resolved per output slot by a 27-wide
      searchsorted-style reduction plus one lane gather.  Bitwise
      identical slots to ``"pack"`` at ~capacity/27 of its reduction
      work: ``"pack"`` re-reads the full (rows, 27*cap_b) plane once
      per output slot, ~8 GB of memory traffic at 10k atoms.
    - ``"pack"``: single-stage prefix-sum pack -- slot of a
      within-cutoff candidate is its running count along the whole
      candidate axis, realized as ``capacity`` masked plane reductions.
      Slot order is stencil-major; on a capacity overflow (flagged
      either way) the candidates dropped are the LAST in stencil order
      rather than the farthest.
    - ``"topk"``: per-row ``lax.top_k`` on a quantized-d2-majored key;
      nearest-first to ~10-bit d2 resolution (overflow drops the
      farthest candidates first), at the cost of a per-row sort that
      dominates the build.

    ``bin_block`` processes bins in ``lax.map`` blocks of that many
    rows so the per-slot extractions reduce a small block of the
    candidate plane instead of the whole plane (None = pick a block
    that bounds the plane to ~2 MB).

    ``assume_wrapped=True`` asserts every position's fractional
    coordinate lies in [0, 1) along periodic directions (the MD engine
    wraps at rebuild time), eliding the per-pair base-image gather.
    """
    n_atoms = positions.shape[0]
    capacity = min(capacity, n_atoms)
    nx, ny, nz = grid_shape
    n_bins = nx * ny * nz
    cap_b = bin_capacity
    if topology is None:
        topology = bin_topology(grid_shape, pbc)
    nbr_bins, nbr_shifts, nbr_valid = (jnp.asarray(t) for t in topology)
    pbc_vec = jnp.asarray(pbc, dtype=positions.dtype).reshape(3)
    frac = cell_transform(positions, jnp.linalg.inv(cell))
    if assume_wrapped:
        # positions are already in the primary cell (caller wrapped by
        # an exact lattice translation); binning clips the ~1-ulp
        # boundary excursions that re-deriving frac can produce --
        # re-wrapping here would silently reintroduce base images
        frac_wrapped = frac
        base_shift = None
        wrapped_pos = positions
    else:
        # wrap periodic directions; base shift restores the originals
        frac_wrapped = jnp.where(pbc_vec > 0, frac % 1.0, frac)
        base_shift = frac - frac_wrapped  # integer image of each atom
        wrapped_pos = cell_transform(frac_wrapped, cell)
    dims = jnp.array(grid_shape, dtype=positions.dtype)
    bin_coord = jnp.clip((frac_wrapped * dims).astype(jnp.int32), 0,
                         jnp.array(grid_shape, dtype=jnp.int32) - 1)
    bin_id = (bin_coord[:, 0] * ny + bin_coord[:, 1]) * nz \
        + bin_coord[:, 2]
    order = jnp.argsort(bin_id)
    sorted_bid = bin_id[order]
    starts = jnp.searchsorted(sorted_bid, jnp.arange(n_bins),
                              side="left")
    counts = jnp.diff(jnp.append(starts, n_atoms))
    overflow_bins = jnp.any(counts > cap_b)
    # bin occupancy table: atom index per (bin, slot), -1-free via mask
    slot = jnp.arange(cap_b)
    gather_idx = jnp.clip(starts[:, None] + slot[None, :], 0,
                          n_atoms - 1)
    bin_atoms = order[gather_idx]                      # (B, cap_b)
    bin_mask = slot[None, :] < counts[:, None]         # (B, cap_b)
    bin_pos = wrapped_pos.at[bin_atoms.reshape(-1)].get(
        mode="promise_in_bounds").reshape(n_bins, cap_b, 3)
    # packed key: [quantized d2 | stencil shift code (5b) | atom id];
    # stencil shift components are in {-1, 0, 1} by construction
    bits_n = max(1, int(np.ceil(np.log2(max(2, n_atoms)))))
    bits_pay = bits_n + 5
    if bits_pay > (31 if selection != "topk" else 30):
        raise ValueError(f"{n_atoms} atoms exceeds the packed-key "
                         "range of the cell-list builder")
    s_int = nbr_shifts.astype(jnp.int32)
    s_code = ((s_int[:, :, 0] + 1) * 9 + (s_int[:, :, 1] + 1) * 3
              + (s_int[:, :, 2] + 1))                  # (B, 27)
    if selection == "topk":
        d2_bits = min(10, 30 - bits_pay)
        if d2_bits < 6:
            # the nearest-first overflow-drop guarantee degrades with
            # the d2 quantization: below ~6 bits (n_atoms > ~2^19)
            # same-bucket candidates tie-break by shift-code/atom-id,
            # and at 0 bits (n_atoms > ~2^25) overflow drops become
            # arbitrary.  The drop order only matters when a row
            # actually overflows (flagged).
            import warnings
            warnings.warn(
                f"cell-list packed key has only {d2_bits} distance "
                f"bits at {n_atoms} atoms: capacity overflow no "
                "longer drops strictly farthest-first (overflow is "
                "still detected)")
    # the candidate plane (rows, 27 * cap_b) is processed in lax.map
    # blocks of bins: the per-slot extraction then reduces a small
    # block (which can stay in cache) instead of re-reading the full
    # plane from device memory per output slot
    if bin_block is None:
        per_bin = max(1, cap_b * 27 * cap_b)
        bin_block = max(1, (2 * 1024 * 1024 // 4) // per_bin)
    bin_block = int(min(max(1, bin_block), n_bins))
    n_blk = -(-n_bins // bin_block)
    pad_b = n_blk * bin_block - n_bins

    def _blk(x):
        if pad_b:
            x = jnp.pad(x, [(0, pad_b)] + [(0, 0)] * (x.ndim - 1))
        return x.reshape((n_blk, bin_block) + x.shape[1:])

    iota_k = jnp.arange(capacity, dtype=jnp.int32)
    big = jnp.int32(2 ** 31 - 1)

    def process(block):
        b_mask, b_pos, b_nbins, b_nshift, b_nvalid, b_scode = block
        bb = b_mask.shape[0]
        flat_bins = b_nbins.reshape(-1)
        # candidates: atoms of each bin's 27 neighbor bins (+ shift)
        cand_atoms = bin_atoms.at[flat_bins].get(
            mode="promise_in_bounds").reshape(bb, 27 * cap_b)
        cand_mask = (bin_mask.at[flat_bins].get(
                         mode="promise_in_bounds")
                     .reshape(bb, 27, cap_b)
                     & b_nvalid[:, :, None]).reshape(bb, 27 * cap_b)
        cand_pos = (bin_pos.at[flat_bins].get(
                        mode="promise_in_bounds")
                    .reshape(bb, 27, cap_b, 3)
                    + cell_transform(b_nshift, cell)[:, :, None, :]
                    ).reshape(bb, 27 * cap_b, 3)
        # squared distances with the candidate axis on vector lanes;
        # per-component accumulation avoids materializing the
        # (bb, cap_b, 27*cap_b, 3) difference tensor
        d2 = jnp.zeros((bb, cap_b, 27 * cap_b), dtype=positions.dtype)
        for c in range(3):
            dc = cand_pos[:, None, :, c] - b_pos[:, :, None, c]
            d2 = d2 + dc * dc
        within = (cand_mask[:, None, :] & b_mask[:, :, None]
                  & (d2 < r_cut * r_cut) & (d2 > 1e-12))
        count_row = jnp.sum(within, axis=-1)
        pay_col = (jnp.repeat(b_scode, cap_b, axis=1)
                   * (1 << bits_n)) + cand_atoms.astype(jnp.int32)
        if selection == "pack2":
            # stage 1: pack each stencil group's cap_b lanes locally.
            # A group holds at most cap_b atoms, so the local pack
            # never overflows; the extraction loop reduces only the
            # 32-lane group axis
            wg = within.reshape(bb, cap_b, 27, cap_b)
            payg = jnp.where(wg, pay_col.reshape(bb, 1, 27, cap_b), 0)
            gslot = jnp.cumsum(wg.astype(jnp.int32), axis=-1)
            packed = jnp.stack(
                [jnp.sum(jnp.where(gslot == lo + 1, payg, 0), axis=-1)
                 for lo in range(cap_b)], axis=-1)  # (bb,cap_b,27,cap_b)
            g_cnt = gslot[..., -1]                  # (bb, cap_b, 27)
            # stage 2: group g's survivors land at the exclusive
            # prefix offset of the group counts; per output slot s the
            # source group is the last one whose offset is <= s (a
            # 27-wide count), the lane is s - offset, and one gather
            # over the group-packed table resolves the key.  Offsets
            # are nondecreasing with off[g+1] = off[g] + cnt[g], so an
            # empty group can win the max only when s >= total (masked)
            off = jnp.cumsum(g_cnt, axis=-1) - g_cnt
            gstar = jnp.sum(
                off[:, :, None, :] <= iota_k[None, None, :, None],
                axis=-1).astype(jnp.int32) - 1      # (bb, cap_b, K)
            offg = jnp.take_along_axis(off, gstar, axis=-1)
            flat = jnp.clip(gstar * cap_b
                            + (iota_k[None, None, :] - offg),
                            0, 27 * cap_b - 1)
            key_sel = jnp.take_along_axis(
                packed.reshape(bb, cap_b, 27 * cap_b), flat, axis=-1)
            mask_sel = iota_k[None, None, :] < count_row[:, :, None]
            key_sel = jnp.where(mask_sel, key_sel, 0)
        elif selection == "pack":
            # single-stage pack: the running within-count along the
            # whole candidate axis IS the output slot; each output
            # slot reduces the full plane once
            slot1 = jnp.cumsum(within.astype(jnp.int32), axis=-1)
            pay_bc = jnp.where(within, pay_col[:, None, :], 0)
            key_sel = jnp.stack(
                [jnp.sum(jnp.where(slot1 == s + 1, pay_bc, 0), axis=-1)
                 for s in range(capacity)], axis=-1)   # (bb, cap_b, K)
            mask_sel = iota_k[None, None, :] < count_row[:, :, None]
            key_sel = jnp.where(mask_sel, key_sel, 0)
        else:
            if d2_bits > 0:
                scale = (2 ** d2_bits - 1) / (r_cut * r_cut)
                d2q = jnp.clip((d2 * scale).astype(jnp.int32), 0,
                               2 ** d2_bits - 1)
                key = d2q * (1 << bits_pay) + pay_col[:, None, :]
            else:
                key = jnp.broadcast_to(pay_col[:, None, :], d2.shape)
            key = jnp.where(within, key, big)
            neg, _ = jax.lax.top_k(-key, capacity)     # (bb, cap_b, K)
            key_sel = -neg
            mask_sel = key_sel < big
        return key_sel, mask_sel, count_row

    key_b, mask_b, count_b = jax.lax.map(
        process, (_blk(bin_mask), _blk(bin_pos), _blk(nbr_bins),
                  _blk(nbr_shifts), _blk(nbr_valid), _blk(s_code)))
    key_sel = key_b.reshape(-1, cap_b, capacity)[:n_bins]
    mask_sel = mask_b.reshape(-1, cap_b, capacity)[:n_bins]
    count_row = count_b.reshape(-1, cap_b)[:n_bins]
    overflow = overflow_bins | jnp.any(count_row > capacity)
    idx_sel = (key_sel & ((1 << bits_n) - 1)).astype(jnp.int32)
    o_sel = (key_sel >> bits_n) & 31
    shift_sel = jnp.stack([(o_sel // 9 - 1).astype(positions.dtype),
                           (o_sel // 3 % 3 - 1).astype(positions.dtype),
                           (o_sel % 3 - 1).astype(positions.dtype)],
                          axis=-1)                     # (B, cap_b, K, 3)
    if assume_wrapped:
        shift_total = shift_sel
    else:
        # relative image shift: candidate image minus this atom's own
        # image (positions were wrapped; restore absolute consistency)
        base_i = jnp.take(base_shift, bin_atoms.reshape(-1),
                          axis=0).reshape(n_bins, cap_b, 3)
        base_j = jnp.take(base_shift, idx_sel.reshape(-1),
                          axis=0).reshape(n_bins, cap_b, capacity, 3)
        shift_total = (shift_sel - base_j + base_i[:, :, None, :])
    # back to atom order via the inverse permutation (gather, no
    # scatter): atom a sits at sorted position inv_order[a], i.e. slot
    # inv_order[a] - starts[bin_id[a]] of its bin row
    inv_order = jnp.argsort(order).astype(jnp.int32)
    atom_slot = inv_order - starts[bin_id].astype(jnp.int32)
    flat_row = bin_id.astype(jnp.int32) * cap_b + atom_slot
    idx_out = idx_sel.reshape(-1, capacity).at[flat_row].get(
        mode="promise_in_bounds")
    shift_out = shift_total.reshape(-1, capacity, 3).at[flat_row].get(
        mode="promise_in_bounds")
    mask_out = mask_sel.reshape(-1, capacity).at[flat_row].get(
        mode="promise_in_bounds")
    self_idx = jnp.arange(n_atoms, dtype=jnp.int32)[:, None]
    idx_out = jnp.where(mask_out, idx_out, self_idx)
    shift_out = jnp.where(mask_out[:, :, None], shift_out, 0.0)
    rev = _reverse_slots(idx_out, shift_out, mask_out) if with_rev \
        else jnp.zeros_like(idx_out)
    return NeighborList(idx=idx_out, shift=shift_out, mask=mask_out,
                        rev=rev, overflow=overflow,
                        reference_positions=positions)


def wrap_positions(positions, cell, pbc):
    """Translate atoms by integer multiples of the cell vectors into
    the primary cell along periodic directions.  The translation is an
    exact lattice vector (integer base times cell rows), so energies
    and forces are invariant to float rounding of the products."""
    pbc_vec = jnp.asarray(pbc, dtype=positions.dtype).reshape(3)
    frac = cell_transform(positions, jnp.linalg.inv(cell))
    base = jnp.floor(frac) * pbc_vec
    return positions - cell_transform(base, cell)


def needs_rebuild(nbr: NeighborList, positions, skin: float) -> jnp.ndarray:
    """True when the list may miss an interaction: a pair outside
    r_cut + skin at build time can only reach r_cut if the two atoms'
    COMBINED drift exceeds the skin, and for any pair that sum is
    bounded by the two largest per-atom drifts.  The top-2-sum
    criterion is therefore sound, while the classic per-atom skin/2
    test it replaces was ~2x over-conservative for the observed
    failure mode (one thermal-tail atom): at the bench cadence the
    single-atom test tripped on launches whose true frozen-list force
    error stayed under 1e-6 eV/A (benchmarks/probe_stale_error.py)."""
    delta = positions - nbr.reference_positions
    d2 = jnp.sum(delta * delta, axis=-1)
    top2, _ = jax.lax.top_k(d2, 2)
    return jnp.sqrt(top2[0]) + jnp.sqrt(top2[1]) > skin


def estimate_capacity(n_atoms: int, volume: float, r_cut: float,
                      factor: float = 1.35, minimum: int = 8) -> int:
    """Padded capacity from mean density with a safety factor."""
    density = n_atoms / volume
    expected = density * 4.0 / 3.0 * np.pi * r_cut ** 3
    return max(minimum, int(np.ceil(expected * factor)))
