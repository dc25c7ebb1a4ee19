"""
Fused 2+3-body force kernels in plain JAX (compiled by XLA) -- the
framework's equivalent of the upstream C++ `pair_style uf3` inner loop
(lammps_plugin/README.rst):

  * atoms are processed in blocks of BA centers with their K-neighbor
    rows (lax.map over blocks bounds the intermediates);
  * closed-form knot windows: every knot strategy (linear / lammps r^2 /
    geometric / inverse) is uniform in a transformed coordinate, so
    interval lookup is a floor() and the 8-knot de Boor window is an
    analytic clip expression -- no searchsorted, no gathers;
  * dense per-leg basis matrices, the grid contraction H = A @ G as one
    matmul per block, and the neighbor-pair loops laid out on a flat
    K*K pair axis;
  * outputs per atom block: energy, center force, and slot-aligned
    neighbor-force partials (S1, S3', V3') so the cross-atom term
    reduces to one row gather after the block map.

The single-trio-type (unary) fast path is `trio_forces_unrolled`;
multi-element systems use `trio_forces_multi` / `pair_forces_multi`
(the same pair-lane computation looped over ordered trio/pair types
with species gates, sharing distances, gathers and the reverse-slot
force assembly across types).  `uf3_tpu.ops.potential` keeps the
factorized einsum kernels as the oracle / general fallback.
"""

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from uf3_tpu.ops.neighbors import cell_transform, gather_rows

LINEAR, LAMMPS, GEOMETRIC, INVERSE = 0, 1, 2, 3

# f32 force contract: max |F_f32 - F_f64 oracle| in eV/A on the bench
# model (rattled bcc W; chip_smoke.py, tests/test_gpu_numerics.py).
F32_FORCE_TOL = 2e-4

# Matmul precision for the trio grid contractions.  Max |dF| against
# the f64 oracle on the 9,826-atom rattled W cell of chip_smoke.py,
# with the contractions traced at each setting in turn on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit: "highest" 6.7e-5, bf16x3
# 7.6e-5, "high" 1.8e-3, default 1.8e-3, TF32 1.8e-3, bf16 1.3e-2
# eV/A.  "high" gives the same max and rms error as the explicit TF32
# algorithm (its compiled HLO names no algorithm), so XLA:GPU runs it
# as TF32, which breaks F32_FORCE_TOL; "highest" keeps it.  The cost
# of "highest" against bf16x3 is not measured.
MATMUL_PRECISION = "highest"


class LegSpec(NamedTuple):
    """Static closed-form description of one leg's knot sequence."""
    kind: int        # transform id
    u0: float        # first knot in transformed coordinate
    h: float         # uniform spacing in transformed coordinate
    n_int: int       # number of intervals (= resolution)
    t_min: float     # r-space lower bound (inclusive mask)
    t_max: float     # r-space upper bound (inclusive mask)
    n_basis: int     # number of basis functions (n_int + 3)
    knots: Tuple[float, ...] = None  # exact interior points (optional):
    #   the reference rounds generated knots to 10 decimals
    #   (knots.py generate_uniform_knots); the closed form is within
    #   ~5e-11 of that, fine for MD (f32) but the exact table is used
    #   by the featurization path for bit-level parity
    cardinal: bool = False  # coefficients re-expressed over uniform
    #   cardinal B-splines (LINEAR knots only): evaluation is floor +
    #   frac + fixed cubic blends -- no de Boor recursion, no divides


# uniform cardinal cubic B-spline blending: w_tap(f) = sum_p M[tap,p] f^p
# on local coordinate f in [0, 1) of an interval; the 4 active basis
# functions at interval k are indices k..k+3
CARDINAL_M = np.array([[1.0, -3.0, 3.0, -1.0],
                       [4.0, 0.0, -6.0, 3.0],
                       [1.0, 3.0, 3.0, -3.0],
                       [0.0, 0.0, 0.0, 1.0]]) / 6.0


def cardinal_coefficients(knot_sequence, coefficients):
    """
    Re-express a clamped cubic spline with UNIFORM interior knots over
    uniform cardinal B-splines (3 phantom knots per side, same basis
    count).  Any C^2 piecewise cubic on uniform breakpoints lies in the
    cardinal span, so the conversion is exact; solved interval-by-
    interval from the piecewise monomial form.  Returns the converted
    coefficient vector (n_int + 3,) or None if knots are non-uniform.
    """
    from uf3_tpu.ops.spline_jax import basis_monomial_table
    seq = np.asarray(knot_sequence, dtype=np.float64)
    pts = seq[3:-3]
    gaps = np.diff(pts)
    if not np.allclose(gaps, gaps[0], rtol=1e-8, atol=1e-10):
        return None
    coefficients = np.asarray(coefficients, dtype=np.float64)
    beta = basis_monomial_table(seq)          # (n_int, tap, power)
    n_int = beta.shape[0]
    poly = np.stack([coefficients[i:i + 4] @ beta[i]
                     for i in range(n_int)])  # (n_int, power)
    uc = np.zeros(n_int + 3)
    uc[0:4] = np.linalg.solve(CARDINAL_M.T, poly[0])
    for i in range(1, n_int):
        # only the new tap is unknown; match the cubic term:
        # poly[i][3] = (-uc[i] + 3 uc[i+1] - 3 uc[i+2] + uc[i+3]) / 6
        uc[i + 3] = (6.0 * poly[i, 3] + uc[i] - 3.0 * uc[i + 1]
                     + 3.0 * uc[i + 2])
    # verify the reconstruction (cheap, catches conditioning issues)
    recon = np.stack([CARDINAL_M.T @ uc[i:i + 4] for i in range(n_int)])
    scale = max(1.0, np.abs(poly).max())
    if np.abs(recon - poly).max() > 1e-8 * scale:
        return None
    return uc


def cardinal_transform_matrix(knot_sequence):
    """(n_basis, n_basis) map from clamped-basis coefficients to
    cardinal coefficients, or None for non-uniform knots."""
    seq = np.asarray(knot_sequence, dtype=np.float64)
    n_basis = len(seq) - 4
    cols = []
    for j in range(n_basis):
        e = np.zeros(n_basis)
        e[j] = 1.0
        uc = cardinal_coefficients(seq, e)
        if uc is None:
            return None
        cols.append(uc)
    return np.stack(cols, axis=1)  # uc = T @ c


def _cardinal4(r, spec: LegSpec):
    """Values and d/dr of the 4 active cardinal basis functions plus
    the interval index: floor + frac + fixed cubic blends (no
    recursion, no divides).  LINEAR (uniform-in-r) knots only."""
    inv_h = 1.0 / spec.h
    tt = (r - spec.u0) * inv_h
    idx = jnp.clip(jnp.floor(tt).astype(jnp.int32), 0, spec.n_int - 1)
    f = tt - idx.astype(r.dtype)
    f2 = f * f
    f3 = f2 * f
    sixth = 1.0 / 6.0
    values = [(1.0 - 3.0 * f + 3.0 * f2 - f3) * sixth,
              (4.0 - 6.0 * f2 + 3.0 * f3) * sixth,
              (1.0 + 3.0 * f + 3.0 * f2 - 3.0 * f3) * sixth,
              f3 * sixth]
    half_h = 0.5 * inv_h
    derivs = [-(1.0 - 2.0 * f + f2) * half_h,
              (3.0 * f2 - 4.0 * f) * half_h,
              (1.0 + 2.0 * f - 3.0 * f2) * half_h,
              f2 * half_h]
    return values, derivs, idx


def leg_spec_from_knots(seq: np.ndarray,
                        exact: bool = False) -> Tuple[bool, LegSpec]:
    """Detect the generating strategy of a clamped knot sequence.
    Returns (ok, spec); ok=False means no closed form applies."""
    seq = np.asarray(seq, dtype=np.float64)
    pts = seq[3:-3]
    n_int = len(pts) - 1
    for kind, fwd in ((LINEAR, lambda x: x), (LAMMPS, np.square),
                      (GEOMETRIC, np.log),
                      (INVERSE, lambda x: 1.0 / x)):
        if kind in (GEOMETRIC, INVERSE) and pts[0] <= 0:
            continue
        u = fwd(pts)
        gaps = np.diff(u)
        if np.allclose(gaps, gaps[0], rtol=1e-6, atol=1e-9):
            return True, LegSpec(
                kind, float(u[0]), float(gaps[0]), n_int,
                float(seq[0]), float(seq[-1]), n_int + 3,
                tuple(float(p) for p in pts) if exact else None)
    return False, None


def _knot_value(spec: LegSpec, k):
    """r-space knot value for (clipped) uniform index k."""
    if spec.knots is not None:
        # exact table lookup via branchless one-hot (small static table)
        table = spec.knots
        out = jnp.full(k.shape, table[0], dtype=jnp.result_type(float))
        for idx_k in range(1, len(table)):
            out = jnp.where(k == idx_k, table[idx_k], out)
        return out
    u = spec.u0 + k * spec.h
    if spec.kind == LINEAR:
        return u
    if spec.kind == LAMMPS:
        return jnp.sqrt(jnp.maximum(u, 0.0))
    if spec.kind == GEOMETRIC:
        return jnp.exp(u)
    return 1.0 / u


def _transform(spec: LegSpec, r):
    if spec.kind == LINEAR:
        return r
    if spec.kind == LAMMPS:
        return r * r
    if spec.kind == GEOMETRIC:
        return jnp.log(r)
    return 1.0 / r


def _leg_interval(spec: LegSpec, r):
    """Interval index (= first non-zero basis index), clipped.  Works
    for decreasing transforms too (h is negative, the quotient is
    monotone increasing in r either way)."""
    u = _transform(spec, r)
    raw = jnp.floor((u - spec.u0) / spec.h).astype(jnp.int32)
    return jnp.clip(raw, 0, spec.n_int - 1)


def _deboor4(r, idx, spec: LegSpec):
    """
    Values and first derivatives of the 4 non-zero cubic basis
    functions, from the analytic knot window t[idx .. idx+7] with
    clamped-end clipping.  Returns (v0..v3, d0..d3) stacked on a new
    trailing-from-python list (8 arrays each shaped like r).
    """
    tk = [_knot_value(spec, jnp.clip(idx + j - 3, 0, spec.n_int))
          for j in range(8)]

    def safe_div(num, den):
        return jnp.where(den != 0, num / jnp.where(den == 0, 1.0, den),
                         jnp.zeros_like(num))

    zero = jnp.zeros_like(r)
    b = [zero, zero, zero, jnp.ones_like(r)]
    for k in range(1, 3):  # degrees 1, 2
        new = [zero, zero, zero, zero]
        for p in range(3 - k, 4):
            term = safe_div(r - tk[p], tk[p + k] - tk[p]) * b[p]
            if p + 1 <= 3:
                term = term + safe_div(tk[p + k + 1] - r,
                                       tk[p + k + 1] - tk[p + 1]) \
                    * b[p + 1]
            new[p] = term
        b = new
    # degree-3 values from degree-2
    values = [zero, zero, zero, zero]
    derivs = [zero, zero, zero, zero]
    for p in range(0, 4):
        term = safe_div(r - tk[p], tk[p + 3] - tk[p]) * b[p]
        dterm = 3.0 * safe_div(b[p], tk[p + 3] - tk[p])
        if p + 1 <= 3:
            term = term + safe_div(tk[p + 4] - r,
                                   tk[p + 4] - tk[p + 1]) * b[p + 1]
            dterm = dterm - 3.0 * safe_div(b[p + 1],
                                           tk[p + 4] - tk[p + 1])
        values[p] = term
        derivs[p] = dterm
    return values, derivs


def _dense_basis(r, valid, spec: LegSpec, lo: int = 0, hi: int = None,
                 transposed: bool = False):
    """Dense basis and derivative matrices over the static basis-index
    window [lo, hi).  ``valid`` may be bool or float; masks are handled
    as float arithmetic.

    The scatter of the 4 active taps into the dense window is ONE
    extended interval one-hot (built once, shared by values and
    derivatives) consumed through 4 statically-shifted FMA chains
    instead of per-(basis, tap) compare+select chains (the one-hot
    costs W+3 compares per element; each output set then pays 4W
    FMAs).  The range gate folds into the 4 tap values once per
    element instead of once per (basis, element).

    transposed=False: (..., hi-lo) with the basis axis minor.
    transposed=True:  (..., hi-lo, P) for r of shape (..., P) -- the
    layout the pair-lane contraction consumes, built directly instead
    of materializing + transposing a (..., P, n_basis) tensor.
    """
    if hi is None:
        hi = spec.n_basis
    if spec.cardinal:
        values, derivs, idx = _cardinal4(r, spec)
    else:
        idx = _leg_interval(spec, r)
        values, derivs = _deboor4(r, idx, spec)
    in_range_f = (valid.astype(r.dtype)
                  * (r >= spec.t_min).astype(r.dtype)
                  * (r <= spec.t_max).astype(r.dtype))
    values = [v * in_range_f for v in values]
    derivs = [d * in_range_f for d in derivs]
    width = hi - lo
    mats = []
    if transposed:
        # ext[..., w2, p] = (idx[..., p] == lo + w2 - 3) over the
        # extended window w2 in [0, width + 3); the basis value at
        # window position w is then sum_tap ext[w + 3 - tap] * tap_w
        shape_ext = r.shape[:-1] + (width + 3, r.shape[-1])
        axis = len(shape_ext) - 2
        ext = (jax.lax.broadcasted_iota(jnp.int32, shape_ext, axis)
               + (lo - 3) == idx[..., None, :]).astype(r.dtype)
        for cols in (values, derivs):
            out = jnp.zeros(r.shape[:-1] + (width, r.shape[-1]),
                            dtype=r.dtype)
            for tap in range(4):
                sl = jax.lax.slice_in_dim(ext, 3 - tap,
                                          3 - tap + width, axis=axis)
                out = out + sl * cols[tap][..., None, :]
            mats.append(out)
    else:
        shape_ext = r.shape + (width + 3,)
        axis = len(r.shape)
        ext = (jax.lax.broadcasted_iota(jnp.int32, shape_ext, axis)
               + (lo - 3) == idx[..., None]).astype(r.dtype)
        for cols in (values, derivs):
            out = jnp.zeros(r.shape + (width,), dtype=r.dtype)
            for tap in range(4):
                sl = jax.lax.slice_in_dim(ext, 3 - tap,
                                          3 - tap + width, axis=axis)
                out = out + sl * cols[tap][..., None]
            mats.append(out)
    return mats[0], mats[1]


VOIGT_AB = ((0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1))


def _trio_virial6(comps, wr, t3_flat, r_mn, w=None):
    """Analytic per-block 3-body virial in Voigt order
    (xx, yy, zz, yz, xz, xy).  Matches the factorized oracle
    (uf3_tpu/ops/potential.py trio_contributions): the g1+g2 leg terms
    collapse to sum_m (w_m / r) d (x) d by neighbor-exchange symmetry
    of the decompressed grids, and the third leg contributes
    1/2 sum_mn (t3 / r_mn) d_mn (x) d_mn over ordered pair lanes.

    ``w`` (BA,) scales each CENTER row's contribution before the
    block reduce -- the domain-decomposition seam: the virial is a sum
    of per-center terms, so owner-weighted shards psum to the exact
    global virial."""
    ba, k = comps[0].shape
    diffs = tuple((jnp.broadcast_to(dc[:, None, :], (ba, k, k))
                   - jnp.broadcast_to(dc[:, :, None], (ba, k, k))
                   ).reshape(ba, k * k) for dc in comps)
    g3f = t3_flat / r_mn
    if w is not None:
        wr = wr * w[:, None]
        g3f = g3f * w[:, None]
    out = []
    for a, b in VOIGT_AB:
        v12 = jnp.sum(wr * comps[a] * comps[b])
        v3t = 0.5 * jnp.sum(g3f * diffs[a] * diffs[b])
        out.append(v12 + v3t)
    return jnp.stack(out)


def _trio_block_compute(comps, valid, grid,
                        spec_l: LegSpec, spec_n: LegSpec,
                        l_dim: int, nc: int,
                        with_energy: bool = True,
                        with_virial: bool = False,
                        active_bc=None,
                        window=None,
                        pair_pre=None,
                        center_w=None,
                        precision=None):
    """
    Fused per-block computation of the trio kernels: from
    per-component displacements (a tuple of three (BA, K) arrays, so
    no array carries a trailing axis of 3) + validity to (energy
    (BA,), center-force components (3-tuple of (BA,)), S1/S3' (BA, K),
    V3' components (3-tuple of (BA, K))).  All loops are static with
    the K*K neighbor pairs on one flat axis; the basis windows and
    (b, c) block list restrict the work to the statically-live part
    of the coefficient grid (the reference's default trims zero ~4/5
    of it).
    """
    dx, dy, dz = comps
    ba, k = dx.shape[0], dx.shape[1]
    dtype = dx.dtype
    if active_bc is None:
        active_bc = tuple((b, tuple(range(nc))) for b in range(l_dim))
    if window is None:
        window = (0, l_dim, 0, nc)
    w_lo, w_hi, c_lo, c_hi = window
    ww, cw = w_hi - w_lo, c_hi - c_lo
    valid_f = valid.astype(dtype)
    r2 = dx * dx + dy * dy + dz * dz
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    a_mat, da_mat = _dense_basis(r, valid_f, spec_l,
                                 lo=w_lo, hi=w_hi)      # (BA, K, Ww)
    # neighbor-neighbor legs per component directly on the K*K pair
    # lane axis (p = m*K + n: value d[n] - d[m]); the role expansions
    # are broadcast views, not repeats (see h_m below)
    r_mn2 = jnp.zeros((ba, k * k), dtype=dtype)
    for dc in comps:
        diff_c = (jnp.broadcast_to(dc[:, None, :], (ba, k, k))
                  - jnp.broadcast_to(dc[:, :, None], (ba, k, k))
                  ).reshape(ba, k * k)
        r_mn2 = r_mn2 + diff_c * diff_c
    r_mn = jnp.sqrt(jnp.where(r_mn2 > 0, r_mn2, 1.0))    # (BA, K*K)
    if pair_pre is None:
        pair_pre = (jnp.tile(valid_f, (1, k))
                    * jnp.repeat(valid_f, k, axis=-1))
    pair_valid = pair_pre * (r_mn2 > 1e-10).astype(dtype)
    # third-leg basis built DIRECTLY in (BA, Cw, K*K) layout -- the
    # contraction's consumption order -- instead of building
    # (BA, K*K, Cw) and paying two 2M-element transposes
    c_p, dc_p = _dense_basis(r_mn, pair_valid, spec_n,
                             lo=c_lo, hi=c_hi, transposed=True)
    if precision is None:
        precision = MATMUL_PRECISION
    g_flat = grid[w_lo:w_hi, w_lo:w_hi, c_lo:c_hi].reshape(ww, ww * cw)
    wc = ww * cw
    h = jnp.dot(a_mat.reshape(ba * k, ww), g_flat,
                precision=precision,
                preferred_element_type=dtype).reshape(ba, k, wc)
    h1 = jnp.dot(da_mat.reshape(ba * k, ww), g_flat,
                 precision=precision,
                 preferred_element_type=dtype).reshape(ba, k, wc)
    # accumulate T[m, n] = sum_bc B[n, b] C[mn, c] H[m, b, c] on the
    # K*K pair-lane axis.  The m-role (repeat) and n-role (tile)
    # expansions are hoisted to ONE broadcast+reshape per tensor --
    # broadcasts on a new minor axis lower to free layout views,
    # while per-(b, c) jnp.repeat calls would move (BA, K*K) tensors
    # through memory 54 times per block
    h_m = jnp.broadcast_to(h.transpose(0, 2, 1)[:, :, :, None],
                           (ba, wc, k, k)).reshape(ba, wc, k * k)
    h1_m = jnp.broadcast_to(h1.transpose(0, 2, 1)[:, :, :, None],
                            (ba, wc, k, k)).reshape(ba, wc, k * k)
    a_n = jnp.broadcast_to(a_mat.transpose(0, 2, 1)[:, :, None, :],
                           (ba, ww, k, k)).reshape(ba, ww, k * k)
    value = jnp.zeros((ba, k * k), dtype=dtype)
    t1 = jnp.zeros((ba, k * k), dtype=dtype)
    t3 = jnp.zeros((ba, k * k), dtype=dtype)
    for b_idx, c_list in active_bc:
        db = jnp.zeros((ba, k * k), dtype=dtype)
        d1b = jnp.zeros((ba, k * k), dtype=dtype)
        d3b = jnp.zeros((ba, k * k), dtype=dtype)
        for c_idx in c_list:
            col = (b_idx - w_lo) * cw + (c_idx - c_lo)
            h_bc = h_m[:, col, :]
            h1_bc = h1_m[:, col, :]
            if with_energy:
                db = db + c_p[:, c_idx - c_lo, :] * h_bc
            d1b = d1b + c_p[:, c_idx - c_lo, :] * h1_bc
            d3b = d3b + dc_p[:, c_idx - c_lo, :] * h_bc
        b_col = a_n[:, b_idx - w_lo, :]
        if with_energy:
            value = value + b_col * db
        t1 = t1 + b_col * d1b
        t3 = t3 + b_col * d3b
    energy = 0.5 * jnp.sum(value, axis=1)
    t1_g = t1.reshape(ba, k, k)
    w_m = jnp.sum(t1_g, axis=2)                          # (BA, K)
    wr = w_m / r
    f_center = tuple(jnp.sum(wr * dc, axis=1) for dc in comps)
    g3p = (t3 / r_mn).reshape(ba, k, k)
    s3 = jnp.sum(g3p, axis=2)
    # v3[m, c] = sum_n g3p[m, n] d[n, c]: per-component broadcast
    # reduce instead of a batched (K x K)@(K x 3) dot_general, which
    # is too small to use a matrix unit well
    v3 = tuple(jnp.sum(g3p * dc[:, None, :], axis=2) for dc in comps)
    if with_virial:
        v6 = _trio_virial6(comps, wr, t3, r_mn, w=center_w)
        return energy, f_center, w_m, s3, v3, v6
    return energy, f_center, w_m, s3, v3


def _tri_layout(k: int):
    """Static m-major strict-upper-triangle lane layout for K slots:
    lanes enumerate pairs (m, n) with m < n as m=0:(n=1..K-1),
    m=1:(n=2..K-1), ...  Returns (n_lanes, lanes_padded, m_idx, n_idx,
    run_starts) as numpy/static values; lanes are padded to the next
    multiple of 128."""
    m_idx, n_idx = [], []
    for m in range(k - 1):
        for n in range(m + 1, k):
            m_idx.append(m)
            n_idx.append(n)
    n_lanes = len(m_idx)
    lanes = -(-max(n_lanes, 1) // 128) * 128
    return (n_lanes, lanes, np.array(m_idx, dtype=np.int32),
            np.array(n_idx, dtype=np.int32))


def _tri_m_role(x, k: int, lanes: int):
    """(BA, K) slot values -> (BA, lanes) with the m-role (constant
    within each m-run) on the triangle lanes; static broadcasts +
    one concat, exact."""
    ba = x.shape[0]
    parts = [jnp.broadcast_to(x[:, m:m + 1], (ba, k - 1 - m))
             for m in range(k - 1)]
    out = jnp.concatenate(parts, axis=1)
    pad = lanes - out.shape[1]
    return jnp.pad(out, ((0, 0), (0, pad))) if pad else out


def _tri_n_role(x, k: int, lanes: int):
    """(BA, K) slot values -> (BA, lanes) with the n-role (slices
    m+1..K-1 per m-run); static slices + one concat, exact."""
    parts = [x[:, m + 1:] for m in range(k - 1)]
    out = jnp.concatenate(parts, axis=1)
    pad = lanes - out.shape[1]
    return jnp.pad(out, ((0, 0), (0, pad))) if pad else out


def _tri_reduce_m(t, k: int):
    """(BA, lanes) -> (BA, K): sum each m-run back to slot m (static
    contiguous slice sums)."""
    cols = []
    start = 0
    for m in range(k - 1):
        run = k - 1 - m
        cols.append(jnp.sum(t[:, start:start + run], axis=1))
        start += run
    cols.append(jnp.zeros_like(cols[0]))
    return jnp.stack(cols, axis=1)


def _tri_reduce_n(t, k: int, n_lanes: int, n_idx):
    """(BA, lanes) -> (BA, K): sum lanes whose n-index is each slot
    (static one-hot masks; the n positions are non-contiguous)."""
    lanes = t.shape[1]
    sel = np.zeros((lanes, k), dtype=np.float32)
    sel[np.arange(n_lanes), n_idx] = 1.0
    return jnp.dot(t, jnp.asarray(sel, dtype=t.dtype),
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=t.dtype)


def _tri_m_role_t(xt, k: int, lanes: int):
    """Tensor m-role: (BA, C, K) slot columns -> (BA, C, lanes) with
    the m-role value constant within each m-run.  ONE concat of
    static broadcasts for all C columns instead of a concat chain per
    live (b, c) column (54 per block)."""
    ba, ncol = xt.shape[0], xt.shape[1]
    parts = [jnp.broadcast_to(xt[:, :, m:m + 1], (ba, ncol, k - 1 - m))
             for m in range(k - 1)]
    out = jnp.concatenate(parts, axis=2)
    pad = lanes - out.shape[2]
    return jnp.pad(out, ((0, 0), (0, 0), (0, pad))) if pad else out


def _tri_n_role_t(xt, k: int, lanes: int):
    """Tensor n-role: (BA, C, K) -> (BA, C, lanes) with the n-role
    slices m+1..K-1 per m-run; one concat for all C columns."""
    parts = [xt[:, :, m + 1:] for m in range(k - 1)]
    out = jnp.concatenate(parts, axis=2)
    pad = lanes - out.shape[2]
    return jnp.pad(out, ((0, 0), (0, 0), (0, pad))) if pad else out


def _trio_block_compute_tri(comps, valid, grid,
                            spec_l: LegSpec, spec_n: LegSpec,
                            l_dim: int, nc: int,
                            with_energy: bool = True,
                            with_virial: bool = False,
                            active_bc=None,
                            window=None,
                            center_w=None):
    """Triangle-symmetric twin of _trio_block_compute for UNARY
    (neighbor-exchange-symmetric) grids: pair lanes cover only the
    strict upper triangle m < n (half the K*K lanes), with the mirror
    contributions recovered by a second accumulation chain
    (g2 = d a'[n]-role of the same value chain) instead of mirror
    lanes.  Exact: grid symmetry G[l, b, c] == G[b, l, c] is required
    (build_trio_bundle only matches unary trios, whose decompressed
    grids are symmetrized).  Outputs match _trio_block_compute."""
    dx, dy, dz = comps
    ba, k = dx.shape[0], dx.shape[1]
    dtype = dx.dtype
    if active_bc is None:
        active_bc = tuple((b, tuple(range(nc))) for b in range(l_dim))
    if window is None:
        window = (0, l_dim, 0, nc)
    w_lo, w_hi, c_lo, c_hi = window
    ww, cw = w_hi - w_lo, c_hi - c_lo
    n_lanes, lanes, m_idx, n_idx = _tri_layout(k)
    valid_f = valid.astype(dtype)
    r2 = dx * dx + dy * dy + dz * dz
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    a_mat, da_mat = _dense_basis(r, valid_f, spec_l,
                                 lo=w_lo, hi=w_hi)      # (BA, K, Ww)
    # triangle-lane displacements for the third leg
    dm = [_tri_m_role(dc, k, lanes) for dc in comps]
    dn = [_tri_n_role(dc, k, lanes) for dc in comps]
    diffs = [b - a for a, b in zip(dm, dn)]
    r_mn2 = diffs[0] ** 2 + diffs[1] ** 2 + diffs[2] ** 2
    r_mn = jnp.sqrt(jnp.where(r_mn2 > 0, r_mn2, 1.0))
    lane_live = np.zeros((1, lanes), dtype=np.float32)
    lane_live[0, :n_lanes] = 1.0
    pair_valid = (_tri_m_role(valid_f, k, lanes)
                  * _tri_n_role(valid_f, k, lanes)
                  * (r_mn2 > 1e-10).astype(dtype)
                  * jnp.asarray(lane_live, dtype=dtype))
    c_p, dc_p = _dense_basis(r_mn, pair_valid, spec_n,
                             lo=c_lo, hi=c_hi, transposed=True)
    g_flat = grid[w_lo:w_hi, w_lo:w_hi, c_lo:c_hi].reshape(ww,
                                                           ww * cw)
    h = jnp.dot(a_mat.reshape(ba * k, ww), g_flat,
                precision=MATMUL_PRECISION,
                preferred_element_type=dtype).reshape(ba, k, ww * cw)
    h1 = jnp.dot(da_mat.reshape(ba * k, ww), g_flat,
                 precision=MATMUL_PRECISION,
                 preferred_element_type=dtype).reshape(ba, k, ww * cw)
    # hoisted tensor roles: ONE concat for all (b, c) columns of h/h1
    # (m-role) and for the Ww basis columns of a/da (n-role), instead
    # of a concat chain per live (b, c)
    h_m = _tri_m_role_t(h.transpose(0, 2, 1), k, lanes)
    h1_m = _tri_m_role_t(h1.transpose(0, 2, 1), k, lanes)
    a_n = _tri_n_role_t(a_mat.transpose(0, 2, 1), k, lanes)
    da_n = _tri_n_role_t(da_mat.transpose(0, 2, 1), k, lanes)
    value = jnp.zeros((ba, lanes), dtype=dtype)
    t1 = jnp.zeros((ba, lanes), dtype=dtype)   # g1: d/dr of m-leg
    t2 = jnp.zeros((ba, lanes), dtype=dtype)   # g2: d/dr of n-leg
    t3 = jnp.zeros((ba, lanes), dtype=dtype)   # d/dr of the third leg
    for b_idx, c_list in active_bc:
        db = jnp.zeros((ba, lanes), dtype=dtype)
        d1b = jnp.zeros((ba, lanes), dtype=dtype)
        d3b = jnp.zeros((ba, lanes), dtype=dtype)
        for c_idx in c_list:
            col = (b_idx - w_lo) * cw + (c_idx - c_lo)
            h_bc = h_m[:, col, :]
            h1_bc = h1_m[:, col, :]
            cp = c_p[:, c_idx - c_lo, :]
            db = db + cp * h_bc
            d1b = d1b + cp * h1_bc
            d3b = d3b + dc_p[:, c_idx - c_lo, :] * h_bc
        b_val = a_n[:, b_idx - w_lo, :]
        b_der = da_n[:, b_idx - w_lo, :]
        if with_energy:
            value = value + b_val * db
        t1 = t1 + b_val * d1b
        t2 = t2 + b_der * db
        t3 = t3 + b_val * d3b
    energy = jnp.sum(value, axis=1)  # unordered pairs: no 1/2
    # leg-derivative slot sums: g1 lands on slot m, g2 on slot n
    w_m = _tri_reduce_m(t1, k) + _tri_reduce_n(t2, k, n_lanes, n_idx)
    wr = w_m / r
    f_center = tuple(jnp.sum(wr * dc, axis=1) for dc in comps)
    g3p = t3 / r_mn
    s3 = (_tri_reduce_m(g3p, k)
          + _tri_reduce_n(g3p, k, n_lanes, n_idx))
    # v3[m] sums g3 * d[n]; v3[n] sums g3 * d[m]
    v3 = tuple(_tri_reduce_m(g3p * dn[c], k)
               + _tri_reduce_n(g3p * dm[c], k, n_lanes, n_idx)
               for c in range(3))
    if with_virial:
        # center_w weights per-center virial terms before the block
        # reduce (domain-decomposition seam; see _trio_virial6)
        wrv = wr if center_w is None else wr * center_w[:, None]
        g3v = g3p if center_w is None else g3p * center_w[:, None]
        out = []
        for a, b in VOIGT_AB:
            v12 = jnp.sum(wrv * comps[a] * comps[b])
            v3t = jnp.sum(g3v * diffs[a] * diffs[b])  # unordered
            out.append(v12 + v3t)
        return energy, f_center, w_m, s3, v3, jnp.stack(out)
    return energy, f_center, w_m, s3, v3


class ForceCache(NamedTuple):
    """Per-chunk loop invariants of the force kernels.

    When the neighbor lists are traced values (MD chunks: they come
    out of the rebuild lax.cond), XLA does NOT hoist loop-invariant
    derived quantities out of the scan -- mask float conversions,
    tile/repeat mask products, shift @ cell products, and strided
    index-column slices get recomputed every step.  This cache
    computes them once per chunk.
    """
    idx_flats: Tuple        # blocked flat (b*N,) neighbor-index groups
    sd: jnp.ndarray         # (3, N, K) shift @ cell per component
    valid: jnp.ndarray      # (N, K) float pre-mask
    pair_pre: jnp.ndarray = None   # (N, K*K) tile*repeat mask (3B)
    rev_flats: Tuple = None        # blocked packed-row gather indices
    valid_b: jnp.ndarray = None     # (N, K) bool mask (3B assembly)
    ptype: jnp.ndarray = None       # (N, K) int pair-type ids (multi)
    s_slot: jnp.ndarray = None      # (N, K) int neighbor species


# neighbor columns per row take: one take per column means many small
# gathers, one flat take over all columns loses the column structure.
# 4 sits between; the best value on the GPU is not measured yet.
GATHER_BLOCK = 4


def blockify_columns(idx_t, block: int = GATHER_BLOCK) -> Tuple:
    """(K, N) index matrix -> tuple of flattened (b*N,) blocks,
    precomputed once per chunk so no per-step index prep remains."""
    k = idx_t.shape[0]
    return tuple(idx_t[k0:k0 + block].reshape(-1)
                 for k0 in range(0, k, block))


def gather_rows_blocks(table, flats, n_rows: int):
    """Gather (N, K, D) rows of ``table`` via pre-blocked flat index
    groups (see blockify_columns).  Indices are in bounds by
    construction (neighbor ids / packed slots), so the gather skips
    the per-row clamp the default 'clip' mode emits."""
    d = table.shape[1]
    outs = [table.at[fl].get(
                mode="promise_in_bounds").reshape(-1, n_rows, d)
            for fl in flats]
    return jnp.concatenate(outs, 0).transpose(1, 0, 2)


def gather_rows_t(table, idx_t):
    """gather_rows from pre-transposed (K, N) indices."""
    return gather_rows_blocks(table, blockify_columns(idx_t),
                              idx_t.shape[1])


def build_pair_cache(idx, shift, mask, cell, dtype,
                     species=None, pair_type=None) -> ForceCache:
    """Loop invariants for pair_forces_unrolled; with ``species`` (and
    optionally the (S, S) ``pair_type`` table) the per-slot species /
    pair-type ids are cached for the multi-species kernels."""
    sd = jnp.stack([shift[..., 0] * cell[0, c]
                    + shift[..., 1] * cell[1, c]
                    + shift[..., 2] * cell[2, c] for c in range(3)])
    cache = ForceCache(idx_flats=blockify_columns(idx.T),
                       sd=sd.astype(dtype),
                       valid=mask.astype(dtype))
    if species is not None:
        s_i = species.astype(jnp.int32)
        s_slot = gather_rows(s_i[:, None], idx)[..., 0]
        cache = cache._replace(s_slot=s_slot)
        if pair_type is not None:
            n_sp = pair_type.shape[0]
            flat = (s_i[:, None] * n_sp + s_slot).reshape(-1)
            cache = cache._replace(
                ptype=pair_type.reshape(-1).at[flat].get(
                    mode="promise_in_bounds").reshape(idx.shape))
    return cache


def build_trio_cache(nbr, cell, dtype, species=None) -> ForceCache:
    """Loop invariants for trio_forces_unrolled / trio_forces_multi."""
    base = build_pair_cache(nbr.idx, nbr.shift, nbr.mask, cell, dtype,
                            species=species)
    valid = base.valid
    k = valid.shape[1]
    pair_pre = (jnp.tile(valid, (1, k))
                * jnp.repeat(valid, k, axis=-1))
    rev_flat = (nbr.idx.astype(jnp.int32) * k
                + nbr.rev.astype(jnp.int32))
    return base._replace(pair_pre=pair_pre,
                         rev_flats=blockify_columns(rev_flat.T),
                         valid_b=nbr.mask)


def _pack_partials(s1, s3, v3_comps):
    """Slot-aligned partials packed as 8-wide rows (padded): the
    cross-atom assembly then needs ONE row gather instead of three
    separate (N*K,), (N*K,), (N*K, 3) gathers.  Returned flattened to
    (..., K*8) so each block writes one contiguous row per atom."""
    k = s1.shape[-1]
    zeros = jnp.zeros(s1.shape, s1.dtype)
    stacked = jnp.stack([s1, s3, *v3_comps, zeros, zeros, zeros],
                        axis=-1)
    return stacked.reshape(s1.shape[:-1] + (k * 8,))


def _pair_chain(r, spec: LegSpec, coefficients, n_basis: int,
                with_energy: bool):
    """Spline value/derivative chains of the closed-form pair kernel:
    4-tap cardinal blends (uniform knots) or de Boor with static
    coefficient selection.  Returns (v_sum, dv_sum) un-masked."""
    if spec.cardinal:
        values, derivs, idx = _cardinal4(r, spec)
    else:
        idx = _leg_interval(spec, r)
        values, derivs = _deboor4(r, idx, spec)
    v_sum = jnp.zeros_like(r)
    dv_sum = jnp.zeros_like(r)
    for tap in range(4):
        c_tap = jnp.zeros_like(r)
        for w in range(n_basis):
            c_tap = jnp.where(idx + tap == w, coefficients[w], c_tap)
        if with_energy:
            v_sum = v_sum + values[tap] * c_tap
        dv_sum = dv_sum + derivs[tap] * c_tap
    return v_sum, dv_sum


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_basis", "with_energy",
                                    "with_virial", "switch"))
def pair_forces_unrolled(coefficients,
                         positions, cell, nbr_idx, nbr_shift, nbr_mask,
                         spec: LegSpec = None,
                         n_basis: int = 0,
                         with_energy: bool = True,
                         with_virial: bool = False,
                         cache: Optional[ForceCache] = None,
                         center_weight=None,
                         switch=None):
    """
    Single-pair-type 2-body energy + forces with closed-form interval
    lookup and static coefficient selection: V(r) and dV/dr via the
    4-tap de Boor kernel (or divide-free cardinal blends for uniform
    knots) dotted with per-tap selected coefficients -- no per-pair
    table gathers or interval one-hots.

    Neighbor positions come in as per-column row takes and every array
    stays (N, K)-shaped per component: no (N, K, 3) tensor is built.

    ``switch=("short" | "tail", r_lo, r_hi)`` restricts the potential
    to one side of the C^2 quintic r-RESPA partition (S(r) V or
    (1 - S(r)) V, including the V dS/dr force term), so the halo MD
    chunk can split inner/outer forces exactly like the single-device
    engine (pair_short_forces / pair_tail_forces).

    Returns (energy_sum, forces (N, 3)).
    """
    dtype = positions.dtype
    if cache is None:
        cache = build_pair_cache(nbr_idx, nbr_shift, nbr_mask, cell,
                                 dtype)
    pj = gather_rows_blocks(positions, cache.idx_flats,
                            positions.shape[0])    # (N, K, 3)
    comps = []
    r2 = jnp.zeros(nbr_idx.shape, dtype)
    for c in range(3):
        dc = pj[..., c] + cache.sd[c] - positions[:, c][:, None]
        comps.append(dc)
        r2 = r2 + dc * dc
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    valid_f = (cache.valid
               * (r > spec.t_min).astype(dtype)
               * (r < spec.t_max).astype(dtype))
    if center_weight is not None:
        # domain-decomposition seam: each row's half of the pair sum
        # (and the fully-local per-row force) counts only when this
        # shard owns the row's center -- cross-shard pairs then sum
        # exactly under psum, halo rows contribute nothing
        valid_f = valid_f * center_weight.astype(dtype)[:, None]
    v_sum, dv_sum = _pair_chain(r, spec, coefficients, n_basis,
                                with_energy or switch is not None)
    if switch is not None:
        side, r_lo, r_hi = switch
        s, ds = _switch_poly(r, r_lo, r_hi)
        if side == "short":
            v_sum, dv_sum = v_sum * s, dv_sum * s + v_sum * ds
        else:
            v_sum, dv_sum = (v_sum * (1.0 - s),
                             dv_sum * (1.0 - s) - v_sum * ds)
    energy = jnp.sum(v_sum * valid_f) if with_energy \
        else jnp.zeros((), dtype=dtype)
    w_pair = 2.0 * dv_sum * valid_f / r
    forces = jnp.stack([jnp.sum(w_pair * dc, axis=1) for dc in comps],
                       axis=-1)
    if with_virial:
        # oracle convention (potential.py pair_contributions): sum of
        # (dvdr / r) d (x) d over ordered pairs, Voigt order
        w_v = 0.5 * w_pair
        virial = jnp.stack([jnp.sum(w_v * comps[a] * comps[b])
                            for a, b in VOIGT_AB])
        return energy, forces, virial
    return energy, forces


@functools.partial(jax.jit,
                   static_argnames=("spec", "with_energy"))
def pair_forces_poly(poly_table,
                     positions, cell, nbr_idx, nbr_shift, nbr_mask,
                     spec: LegSpec = None,
                     with_energy: bool = True):
    """
    Single-pair-type 2-body energy + forces via per-interval cubic
    polynomials: V(r) restricted to one knot interval is an exact cubic
    (any knot strategy), so instead of the 4-tap de Boor recursion +
    per-basis coefficient selection we do one closed-form interval
    lookup and a one-hot matmul against a tiny (n_int, 9) table packing
    [t_lo, inv_h, e0..e3, f0..f2] (f = dV/dr Horner coefficients).

    Same result as pair_forces_unrolled to ~1e-7 relative (the table is
    built in f64); ~4x fewer elementwise ops.  Returns (energy_sum,
    forces).
    """
    n_int = poly_table.shape[0]
    d = (positions[nbr_idx] + cell_transform(nbr_shift, cell)
         - positions[:, None, :])
    r2 = jnp.sum(d * d, axis=-1)
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    valid_f = (nbr_mask.astype(d.dtype)
               * (r > spec.t_min).astype(d.dtype)
               * (r < spec.t_max).astype(d.dtype))
    idx = _leg_interval(spec, r)
    one_hot = (idx[..., None]
               == jax.lax.broadcasted_iota(jnp.int32,
                                           idx.shape + (n_int,),
                                           idx.ndim)).astype(d.dtype)
    # HIGHEST precision: a default-precision f32 matmul may round its
    # inputs (bf16 or TF32), which loses up to ~0.4% of the table
    # values (0.05 eV/A on the steep wall).  The matmul is tiny, full
    # f32 costs nothing here.
    rows = jnp.dot(one_hot.reshape(-1, n_int), poly_table,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=d.dtype).reshape(
                       idx.shape + (poly_table.shape[1],))
    u = (r - rows[..., 0]) * rows[..., 1]
    dv = ((rows[..., 8] * u + rows[..., 7]) * u + rows[..., 6]) * valid_f
    if with_energy:
        v = (((rows[..., 5] * u + rows[..., 4]) * u
              + rows[..., 3]) * u + rows[..., 2])
        energy = jnp.sum(v * valid_f)
    else:
        energy = jnp.zeros((), dtype=d.dtype)
    unit = d / r[..., None]
    forces = 2.0 * jnp.sum(dv[..., None] * unit, axis=1)
    return energy, forces


def build_pair_poly(model, dtype=jnp.float32):
    """(LegSpec, (n_int, 9) table) for pair_forces_poly, or None."""
    from uf3_tpu.ops.spline_jax import build_pair_tables
    config = model.bspline_config
    pairs = config.interactions_map[2]
    if len(pairs) != 1:
        return None
    pair = pairs[0]
    seq = np.asarray(config.knots_map[pair], dtype=np.float64)
    ok, spec = leg_spec_from_knots(seq)
    if not ok:
        return None
    sizes, offsets = config.get_interaction_partitions()
    coefficients = model.coefficients[offsets[pair]:offsets[pair]
                                      + sizes[pair]]
    poly_e, poly_f, breaks = build_pair_tables(seq, coefficients)
    table = np.concatenate([breaks, poly_e, poly_f[:, :3]], axis=1)
    return spec, jnp.asarray(table, dtype=dtype)


def build_pair_fast(model, dtype=jnp.float32):
    """(LegSpec, coefficients) for the closed-form pair path, or None
    (multi-pair-type / non-closed-form knots)."""
    config = model.bspline_config
    pairs = config.interactions_map[2]
    if len(pairs) != 1:
        return None
    pair = pairs[0]
    ok, spec = leg_spec_from_knots(config.knots_map[pair])
    if not ok:
        return None
    sizes, offsets = config.get_interaction_partitions()
    coefficients = model.coefficients[offsets[pair]:offsets[pair]
                                      + sizes[pair]]
    if spec.kind == LINEAR:
        uc = cardinal_coefficients(config.knots_map[pair], coefficients)
        if uc is not None:
            return (spec._replace(cardinal=True),
                    jnp.asarray(uc, dtype=dtype))
    return spec, jnp.asarray(coefficients, dtype=dtype)


class TrioBundle(NamedTuple):
    """Host-side bundle: compiled-kernel factory inputs."""
    spec_l: LegSpec
    spec_n: LegSpec
    grid: jnp.ndarray
    l_basis: int
    n_basis: int
    active_bc: Tuple = None  # static ((b, (c, ...)), ...) live blocks
    window: Tuple = None     # static (w_lo, w_hi, c_lo, c_hi) live span
    symmetric: bool = False  # grid[l, b, c] == grid[b, l, c]: the
    #   triangle-lane kernel (half the pair-lane work) is exact


def build_trio_bundle(model, dtype=jnp.float32):
    """Closed-form leg specs + dense grid for the single-trio fast
    path; returns None when the model shape is not eligible."""
    config = model.bspline_config
    if config.degree <= 2:
        return None
    trios = config.interactions_map[3]
    if len(trios) != 1:
        return None
    trio = trios[0]
    seqs = [np.asarray(s, dtype=np.float64)
            for s in config.knots_map[trio]]
    if not np.array_equal(seqs[0], seqs[1]):
        return None
    ok_l, spec_l = leg_spec_from_knots(seqs[0])
    ok_n, spec_n = leg_spec_from_knots(seqs[2])
    if not (ok_l and ok_n):
        return None
    from uf3_tpu.regression.least_squares import arrange_coefficients
    solutions = arrange_coefficients(model.coefficients, config)
    grid = config.decompress_3B(solutions[trio], trio)
    # static sparsity: trimmed/symmetry-dead coefficients are exact
    # zeros of the grid; (b, c) blocks with an all-zero G[:, b, c]
    # column are skipped in the pair-lane contraction (the reference's
    # default 3B trims zero 3 leading + 3 trailing basis fns per leg,
    # which kills ~4/5 of the dense L x NC loop).  NOTE: this is why
    # the trio legs stay in the clamped basis -- the cardinal
    # re-expression would densify the zero pattern.
    grid = np.asarray(grid, dtype=np.float64)
    alive = ~np.all(grid == 0.0, axis=0)           # (M, NC)
    active_bc = tuple(
        (b, tuple(int(c) for c in np.nonzero(alive[b])[0]))
        for b in range(grid.shape[1]) if alive[b].any())
    if active_bc:
        l_alive = np.nonzero(~np.all(grid == 0.0, axis=(1, 2)))[0]
        bs = [b for b, _ in active_bc]
        cs = [c for _, cl in active_bc for c in cl]
        w_lo = int(min(l_alive.min(), min(bs)))
        w_hi = int(max(l_alive.max(), max(bs))) + 1
        window = (w_lo, w_hi, int(min(cs)), int(max(cs)) + 1)
    else:
        window = (0, grid.shape[0], 0, grid.shape[2])
    symmetric = bool(np.array_equal(grid, grid.transpose(1, 0, 2)))
    return TrioBundle(spec_l=spec_l, spec_n=spec_n,
                      grid=jnp.asarray(grid, dtype=dtype),
                      l_basis=grid.shape[0], n_basis=grid.shape[2],
                      active_bc=active_bc, window=window,
                      symmetric=symmetric)


def _assemble_forces(energy, f_center, packed, comps, r,
                     cache: ForceCache):
    """Neighbor-term assembly: one packed row gather through inverse
    slots, as flattened single-index blocked takes of 8-wide rows
    (see _pack_partials).
    ``f_center`` may be a (N, 3) array or a 3-tuple of (N,) columns."""
    n_atoms = r.shape[0]
    rows = gather_rows_blocks(packed.reshape(-1, 8), cache.rev_flats,
                              n_atoms)                 # (N, K, 8)
    s1g = rows[..., 0]
    s3g = rows[..., 1]
    mask = cache.valid_b
    cols = []
    for c in range(3):
        contrib = (s1g * (comps[c] / r) + s3g * comps[c]
                   + rows[..., 2 + c])
        fc_c = f_center[c] if isinstance(f_center, tuple) \
            else f_center[:, c]
        cols.append(fc_c + jnp.sum(jnp.where(mask, contrib, 0.0),
                                   axis=1))
    return energy, jnp.stack(cols, axis=-1)


@functools.partial(jax.jit,
                   static_argnames=("spec_l", "spec_n", "l_basis",
                                    "n_basis", "block_atoms",
                                    "with_energy", "with_virial",
                                    "active_bc", "window",
                                    "triangle"))
def trio_forces_unrolled(grid,
                         positions, cell, nbr_idx, nbr_shift, nbr_mask,
                         nbr_rev,
                         spec_l: LegSpec = None,
                         spec_n: LegSpec = None,
                         l_basis: int = 0,
                         n_basis: int = 0,
                         block_atoms: int = 512,
                         with_energy: bool = True,
                         with_virial: bool = False,
                         active_bc=None,
                         window=None,
                         triangle: bool = False,
                         cache: Optional[ForceCache] = None,
                         center_weight=None,
                         comps=None):
    """
    Fused single-trio-type 3-body energy + forces: the pair-lane
    computation applied blockwise with lax.map to bound intermediate
    materialization.  With ``with_energy=False`` the value-accumulation
    chain is elided (MD inner steps need forces only).  With
    ``with_virial=True`` the return gains the analytic Voigt virial
    (xx, yy, zz, yz, xz, xy).
    ``comps`` (3-tuple of (N, K)) reuses an existing displacement
    gather (3-level r-RESPA shares the innermost step's rows).

    ``center_weight`` (N,) scales each CENTER row's outputs (energy,
    center force, emitted neighbor partials) before assembly -- the
    domain-decomposition seam: halo-atom rows get weight 0 so their
    triangles are counted only by the shard that owns the center,
    while partials emitted by owned centers onto halo slots still
    assemble (and are shipped back by the caller).
    """
    n_atoms, capacity = nbr_idx.shape
    # the strict-upper-triangle lane layout needs at least one m < n
    # pair; at capacity 1 fall back to the ordered-lane kernel
    triangle = triangle and capacity >= 2
    if cache is None:
        cache = build_pair_cache(nbr_idx, nbr_shift, nbr_mask, cell,
                                 positions.dtype)
        k = capacity
        cache = cache._replace(
            pair_pre=(jnp.tile(cache.valid, (1, k))
                      * jnp.repeat(cache.valid, k, axis=-1)),
            rev_flats=blockify_columns(
                (nbr_idx.astype(jnp.int32) * k
                 + nbr_rev.astype(jnp.int32)).T),
            valid_b=nbr_mask)
    if comps is None:
        pj = gather_rows_blocks(positions, cache.idx_flats,
                                positions.shape[0])
        comps = tuple(pj[..., c] + cache.sd[c]
                      - positions[:, c][:, None] for c in range(3))
    r2 = comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    pad = (-n_atoms) % block_atoms

    def blocks(a):
        return jnp.pad(a, ((0, pad), (0, 0))).reshape(
            -1, block_atoms, a.shape[1])

    c_blocks = tuple(blocks(dc) for dc in comps)
    m_blocks = blocks(cache.valid)
    p_blocks = blocks(cache.pair_pre)
    # the virial is block-reduced inside the map, so center weights
    # must ride into the blocks (energy/forces are weighted post hoc)
    weight_virial = center_weight is not None and with_virial
    if weight_virial:
        w_blocks = blocks(
            center_weight.astype(positions.dtype)[:, None])[..., 0]
    else:
        w_blocks = m_blocks  # unused placeholder, keeps arity static

    def block_fn(args):
        cx, cy, cz, m_b, p_b, w_b = args
        c_w = w_b if weight_virial else None
        if triangle:
            out = _trio_block_compute_tri(
                (cx, cy, cz), m_b, grid, spec_l, spec_n, l_basis,
                n_basis, with_energy=with_energy,
                with_virial=with_virial, active_bc=active_bc,
                window=window, center_w=c_w)
        else:
            out = _trio_block_compute(
                (cx, cy, cz), m_b, grid, spec_l, spec_n, l_basis,
                n_basis, with_energy=with_energy,
                with_virial=with_virial, active_bc=active_bc,
                window=window, pair_pre=p_b, center_w=c_w)
        energy, f_center, s1, s3, v3 = out[:5]
        # pack inside the block so lax.map writes the gather-ready
        # layout directly, flattened to (BA, K*8) rows
        packed = (energy, jnp.stack(f_center, axis=-1),
                  _pack_partials(s1, s3, v3))
        return packed + (out[5],) if with_virial else packed

    outs = jax.lax.map(block_fn,
                       c_blocks + (m_blocks, p_blocks, w_blocks))
    energy, f_center, packed = outs[:3]
    energy = energy.reshape(-1)[:n_atoms]
    f_center = f_center.reshape(-1, 3)[:n_atoms]
    packed = packed.reshape(-1, capacity * 8)[:n_atoms]
    if center_weight is not None:
        w = center_weight.astype(energy.dtype)
        energy = energy * w
        f_center = f_center * w[:, None]
        packed = packed * w[:, None]
    result = _assemble_forces(energy, f_center, packed, comps, r,
                              cache)
    if with_virial:
        return result + (jnp.sum(outs[3], axis=0),)
    return result


# ---------------------------------------------------------------------------
# multi-species fused path: the same pair-lane kernel looped over trio
# types with species masks, sharing distances/gathers across types
# ---------------------------------------------------------------------------
class TrioTypeDesc(NamedTuple):
    """Static per-ordered-trio-type description for the fused
    multi-species kernel.  Window is the 6-tuple
    (l_lo, l_hi, b_lo, b_hi, c_lo, c_hi) of live basis spans."""
    spec_l1: LegSpec
    spec_l2: LegSpec
    spec_n: LegSpec
    s_c: int
    s_m: int
    s_n: int
    window: Tuple
    active_bc: Tuple


class TrioMulti(NamedTuple):
    """Host-side bundle for the fused multi-species 3-body path."""
    descs: Tuple                 # tuple of TrioTypeDesc (static)
    grids: Tuple                 # per-type dense (L, M, NC) grids
    z_to_species: np.ndarray


def build_trio_multi(model, dtype=jnp.float32):
    """Per-ordered-trio-type specs + grids for the fused multi-species
    kernel; returns None when any knot sequence has no closed form."""
    from uf3_tpu.data import elements
    from uf3_tpu.regression.least_squares import arrange_coefficients
    config = model.bspline_config
    if config.degree <= 2:
        return None
    element_list = list(config.chemical_system.element_list)
    z_list = [elements.atomic_numbers[el] for el in element_list]
    z_to_species = np.zeros(max(z_list) + 1, dtype=np.int32)
    for s, z in enumerate(z_list):
        z_to_species[z] = s
    solutions = arrange_coefficients(model.coefficients, config)
    descs = []
    grids = []
    for trio in config.interactions_map[3]:
        s_c = element_list.index(trio[0])
        s_m = element_list.index(trio[1])
        s_n = element_list.index(trio[2])
        grid = np.asarray(config.decompress_3B(solutions[trio], trio),
                          dtype=np.float64)
        seqs = [np.asarray(s, dtype=np.float64)
                for s in config.knots_map[trio]]
        variants = [((s_c, s_m, s_n), grid, seqs)]
        if s_m != s_n:
            variants.append(((s_c, s_n, s_m), grid.transpose(1, 0, 2),
                             [seqs[1], seqs[0], seqs[2]]))
        for (c, m, n), g, sq in variants:
            ok1, sp1 = leg_spec_from_knots(sq[0])
            ok2, sp2 = leg_spec_from_knots(sq[1])
            okn, spn = leg_spec_from_knots(sq[2])
            if not (ok1 and ok2 and okn):
                return None
            alive = ~np.all(g == 0.0, axis=0)       # (M, NC)
            active_bc = tuple(
                (b, tuple(int(cc) for cc in np.nonzero(alive[b])[0]))
                for b in range(g.shape[1]) if alive[b].any())
            if active_bc:
                l_alive = np.nonzero(~np.all(g == 0.0,
                                             axis=(1, 2)))[0]
                bs = [b for b, _ in active_bc]
                cs = [cc for _, cl in active_bc for cc in cl]
                window = (int(l_alive.min()), int(l_alive.max()) + 1,
                          int(min(bs)), int(max(bs)) + 1,
                          int(min(cs)), int(max(cs)) + 1)
            else:
                window = (0, g.shape[0], 0, g.shape[1], 0, g.shape[2])
            descs.append(TrioTypeDesc(
                spec_l1=sp1, spec_l2=sp2, spec_n=spn,
                s_c=c, s_m=m, s_n=n,
                window=window, active_bc=active_bc))
            grids.append(jnp.asarray(g, dtype=dtype))
    return TrioMulti(descs=tuple(descs), grids=tuple(grids),
                     z_to_species=z_to_species)


def _trio_block_compute_multi(comps, valid_f, s_slot, s_center, grids,
                              descs, with_energy=True,
                              with_virial=False, pair_pre=None):
    """Multi-type twin of _trio_block_compute: distances, pair-lane
    masks and the rev-ready output layout are shared; each ordered trio
    type contributes its own species-gated dense bases and chains."""
    dx, dy, dz = comps
    ba, k = dx.shape[0], dx.shape[1]
    dtype = dx.dtype
    r2 = dx * dx + dy * dy + dz * dz
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    r_mn2 = jnp.zeros((ba, k * k), dtype=dtype)
    for dc in comps:
        diff_c = jnp.tile(dc, (1, k)) - jnp.repeat(dc, k, axis=-1)
        r_mn2 = r_mn2 + diff_c * diff_c
    r_mn = jnp.sqrt(jnp.where(r_mn2 > 0, r_mn2, 1.0))
    if pair_pre is None:
        pair_pre = (jnp.tile(valid_f, (1, k))
                    * jnp.repeat(valid_f, k, axis=-1))
    sep = (r_mn2 > 1e-10).astype(dtype)
    value = jnp.zeros((ba, k * k), dtype=dtype)
    t1 = jnp.zeros((ba, k * k), dtype=dtype)
    t3 = jnp.zeros((ba, k * k), dtype=dtype)
    n_types = len(descs)
    # species gates are needed unless this is genuinely unary
    trivial = (n_types == 1
               and descs[0].s_c == descs[0].s_m == descs[0].s_n == 0)
    for desc, grid in zip(descs, grids):
        w_l_lo, w_l_hi, w_b_lo, w_b_hi, c_lo, c_hi = desc.window
        lw = w_l_hi - w_l_lo
        bw = w_b_hi - w_b_lo
        cw = c_hi - c_lo
        if not trivial:
            c_gate = (s_center == desc.s_c).astype(dtype)    # (BA,)
            m_ok = valid_f * (s_slot == desc.s_m).astype(dtype)
            n_ok = valid_f * (s_slot == desc.s_n).astype(dtype)
        else:
            c_gate = jnp.ones((ba,), dtype=dtype)
            m_ok = n_ok = valid_f
        a_mat, da_mat = _dense_basis(r, m_ok, desc.spec_l1,
                                     lo=w_l_lo, hi=w_l_hi)
        if (desc.spec_l2 == desc.spec_l1 and desc.s_m == desc.s_n
                and (w_l_lo, w_l_hi) == (w_b_lo, w_b_hi)):
            b_src = a_mat
            b_lo = w_l_lo
        else:
            b_src, _ = _dense_basis(r, n_ok, desc.spec_l2,
                                    lo=w_b_lo, hi=w_b_hi)
            b_lo = w_b_lo
        # pair mask: m on repeated lanes, n on tiled lanes
        ppre = (jnp.tile(n_ok, (1, k)) * jnp.repeat(m_ok, k, axis=-1)
                if not trivial else pair_pre)
        pair_valid = ppre * sep
        c_p, dc_p = _dense_basis(r_mn, pair_valid, desc.spec_n,
                                 lo=c_lo, hi=c_hi, transposed=True)
        g_flat = grid[w_l_lo:w_l_hi, w_b_lo:w_b_hi,
                      c_lo:c_hi].reshape(lw, bw * cw)
        h = jnp.dot(a_mat.reshape(ba * k, lw), g_flat,
                    precision=MATMUL_PRECISION,
                    preferred_element_type=dtype).reshape(ba, k, bw,
                                                          cw)
        h1 = jnp.dot(da_mat.reshape(ba * k, lw), g_flat,
                     precision=MATMUL_PRECISION,
                     preferred_element_type=dtype).reshape(ba, k, bw,
                                                           cw)
        for b_idx, c_list in desc.active_bc:
            hb = h[:, :, b_idx - w_b_lo, :]
            h1b = h1[:, :, b_idx - w_b_lo, :]
            db = jnp.zeros((ba, k * k), dtype=dtype)
            d1b = jnp.zeros((ba, k * k), dtype=dtype)
            d3b = jnp.zeros((ba, k * k), dtype=dtype)
            for c_idx in c_list:
                h_bc = jnp.repeat(hb[:, :, c_idx - c_lo], k, axis=-1)
                h1_bc = jnp.repeat(h1b[:, :, c_idx - c_lo], k, axis=-1)
                if with_energy:
                    db = db + c_p[:, c_idx - c_lo, :] * h_bc
                d1b = d1b + c_p[:, c_idx - c_lo, :] * h1_bc
                d3b = d3b + dc_p[:, c_idx - c_lo, :] * h_bc
            b_col = jnp.tile(b_src[:, :, b_idx - b_lo], (1, k)) \
                * c_gate[:, None]
            if with_energy:
                value = value + b_col * db
            t1 = t1 + b_col * d1b
            t3 = t3 + b_col * d3b
    energy = 0.5 * jnp.sum(value, axis=1)
    t1_g = t1.reshape(ba, k, k)
    w_m = jnp.sum(t1_g, axis=2)
    wr = w_m / r
    f_center = tuple(jnp.sum(wr * dc, axis=1) for dc in comps)
    g3p = (t3 / r_mn).reshape(ba, k, k)
    s3 = jnp.sum(g3p, axis=2)
    v3 = tuple(jnp.sum(g3p * dc[:, None, :], axis=2) for dc in comps)
    if with_virial:
        v6 = _trio_virial6(comps, wr, t3, r_mn)
        return energy, f_center, w_m, s3, v3, v6
    return energy, f_center, w_m, s3, v3


@functools.partial(jax.jit,
                   static_argnames=("descs", "block_atoms",
                                    "with_energy", "with_virial"))
def trio_forces_multi(grids, species,
                      positions, cell, nbr_idx, nbr_shift, nbr_mask,
                      nbr_rev,
                      descs: Tuple = None,
                      block_atoms: int = 512,
                      with_energy: bool = True,
                      with_virial: bool = False,
                      cache: Optional[ForceCache] = None):
    """Fused multi-species 3-body energy + forces.  ``species`` is the
    compact per-atom species index array; grids is the per-type tuple
    from build_trio_multi.  Returns (atom_energy, forces)."""
    n_atoms, capacity = nbr_idx.shape
    if cache is None:
        cache = build_pair_cache(nbr_idx, nbr_shift, nbr_mask, cell,
                                 positions.dtype)
        cache = cache._replace(
            pair_pre=(jnp.tile(cache.valid, (1, capacity))
                      * jnp.repeat(cache.valid, capacity, axis=-1)),
            rev_flats=blockify_columns(
                (nbr_idx.astype(jnp.int32) * capacity
                 + nbr_rev.astype(jnp.int32)).T),
            valid_b=nbr_mask)
    pj = gather_rows_blocks(positions, cache.idx_flats, n_atoms)
    comps = tuple(pj[..., c] + cache.sd[c]
                  - positions[:, c][:, None] for c in range(3))
    r2 = comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    s_slot = cache.s_slot if cache.s_slot is not None else \
        gather_rows(species[:, None].astype(jnp.int32),
                    nbr_idx)[..., 0]               # (N, K)
    s_center = species.astype(jnp.int32)
    pad = (-n_atoms) % block_atoms

    def blocks(a):
        return jnp.pad(a, ((0, pad), (0, 0))).reshape(
            -1, block_atoms, a.shape[1])

    c_blocks = tuple(blocks(dc) for dc in comps)
    m_blocks = blocks(cache.valid)
    p_blocks = blocks(cache.pair_pre)
    s_blocks = blocks(s_slot)
    sc_blocks = jnp.pad(s_center, (0, pad)).reshape(-1, block_atoms)

    def block_fn(args):
        cx, cy, cz, m_b, p_b, s_b, sc_b = args
        out = _trio_block_compute_multi(
            (cx, cy, cz), m_b, s_b, sc_b, grids, descs,
            with_energy=with_energy, with_virial=with_virial,
            pair_pre=p_b)
        energy, f_center, s1, s3, v3 = out[:5]
        packed = (energy, jnp.stack(f_center, axis=-1),
                  _pack_partials(s1, s3, v3))
        return packed + (out[5],) if with_virial else packed

    outs = jax.lax.map(
        block_fn, c_blocks + (m_blocks, p_blocks, s_blocks, sc_blocks))
    energy, f_center, packed = outs[:3]
    energy = energy.reshape(-1)[:n_atoms]
    f_center = f_center.reshape(-1, 3)[:n_atoms]
    packed = packed.reshape(-1, capacity * 8)[:n_atoms]
    result = _assemble_forces(energy, f_center, packed, comps, r,
                              cache)
    if with_virial:
        return result + (jnp.sum(outs[3], axis=0),)
    return result


def build_pair_multi(model, dtype=jnp.float32):
    """(specs tuple, coefficient tuple, (S, S) pair-type table,
    z_to_species) for the fused multi-pair-type kernel, or None when
    any knot sequence has no closed form."""
    from uf3_tpu.data import elements
    config = model.bspline_config
    element_list = list(config.chemical_system.element_list)
    n_species = len(element_list)
    z_list = [elements.atomic_numbers[el] for el in element_list]
    z_to_species = np.zeros(max(z_list) + 1, dtype=np.int32)
    for s, z in enumerate(z_list):
        z_to_species[z] = s
    sizes, offsets = config.get_interaction_partitions()
    pair_type = np.zeros((n_species, n_species), dtype=np.int32)
    specs = []
    coeffs = []
    for p_idx, pair in enumerate(config.interactions_map[2]):
        ok, spec = leg_spec_from_knots(config.knots_map[pair])
        if not ok:
            return None
        s_a = element_list.index(pair[0])
        s_b = element_list.index(pair[1])
        pair_type[s_a, s_b] = p_idx
        pair_type[s_b, s_a] = p_idx
        c = model.coefficients[offsets[pair]:offsets[pair]
                               + sizes[pair]]
        if spec.kind == LINEAR:
            uc = cardinal_coefficients(config.knots_map[pair], c)
            if uc is not None:
                spec = spec._replace(cardinal=True)
                c = uc
        specs.append(spec)
        coeffs.append(jnp.asarray(c, dtype=dtype))
    return (tuple(specs), tuple(coeffs),
            jnp.asarray(pair_type), z_to_species)


@functools.partial(jax.jit,
                   static_argnames=("specs", "with_energy",
                                    "with_virial"))
def pair_forces_multi(coeffs, positions, cell, nbr_idx, nbr_shift,
                      nbr_mask,
                      specs: Tuple = None,
                      with_energy: bool = True,
                      with_virial: bool = False,
                      cache: Optional[ForceCache] = None):
    """Fused multi-pair-type 2-body energy + forces: one displacement
    gather shared by all types, per-type spline chains gated by the
    cached pair-type ids.  Returns (energy_sum, forces (N, 3))."""
    dtype = positions.dtype
    if cache is None:
        raise ValueError("pair_forces_multi requires a ForceCache "
                         "built with species + pair_type")
    pj = gather_rows_blocks(positions, cache.idx_flats,
                            positions.shape[0])
    comps = []
    r2 = jnp.zeros(nbr_idx.shape, dtype)
    for c in range(3):
        dc = pj[..., c] + cache.sd[c] - positions[:, c][:, None]
        comps.append(dc)
        r2 = r2 + dc * dc
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    v_sum = jnp.zeros_like(r)
    dv_sum = jnp.zeros_like(r)
    for p, spec in enumerate(specs):
        valid_f = (cache.valid
                   * (r > spec.t_min).astype(dtype)
                   * (r < spec.t_max).astype(dtype))
        if len(specs) > 1:
            valid_f = valid_f * (cache.ptype == p).astype(dtype)
        if spec.cardinal:
            values, derivs, idx = _cardinal4(r, spec)
        else:
            idx = _leg_interval(spec, r)
            values, derivs = _deboor4(r, idx, spec)
        v_p = jnp.zeros_like(r)
        dv_p = jnp.zeros_like(r)
        for tap in range(4):
            c_tap = jnp.zeros_like(r)
            for w in range(spec.n_basis):
                c_tap = jnp.where(idx + tap == w, coeffs[p][w], c_tap)
            if with_energy:
                v_p = v_p + values[tap] * c_tap
            dv_p = dv_p + derivs[tap] * c_tap
        if with_energy:
            v_sum = v_sum + v_p * valid_f
        dv_sum = dv_sum + dv_p * valid_f
    energy = jnp.sum(v_sum) if with_energy \
        else jnp.zeros((), dtype=dtype)
    w_pair = 2.0 * dv_sum / r
    forces = jnp.stack([jnp.sum(w_pair * dc, axis=1) for dc in comps],
                       axis=-1)
    if with_virial:
        w_v = 0.5 * w_pair
        virial = jnp.stack([jnp.sum(w_v * comps[a] * comps[b])
                            for a, b in VOIGT_AB])
        return energy, forces, virial
    return energy, forces


def select_minor(comps, sel, k_parent: int):
    """Minor-axis selection: out[a, k] = comp[a, sel[a, k]] for each
    per-component (N, K_parent) array, via a one-hot broadcast-reduce
    instead of a gather along the minor axis."""
    oh = (sel[:, :, None]
          == jax.lax.broadcasted_iota(
              jnp.int32, sel.shape + (k_parent,), 2)
          ).astype(comps[0].dtype)
    return tuple(jnp.sum(oh * c[:, None, :], axis=2) for c in comps)


def basis_window_hi(spec: LegSpec, r_hi: float) -> int:
    """Number of pair basis functions with support below ``r_hi``:
    the short-range switched force S(r) V(r) vanishes identically for
    r >= r_hi (S = dS = 0), so the coefficient-selection chain can
    stop at interval(r_hi) + 4 -- e.g. 13 of 18 basis functions at
    the bench model's r_hi = 3.5 A.  Exact: skipped selects only ever
    fire on lanes the switch already zeroes."""
    if spec.kind == LINEAR:
        u = r_hi
    elif spec.kind == LAMMPS:
        u = r_hi * r_hi
    elif spec.kind == GEOMETRIC:
        u = np.log(r_hi)
    else:
        u = 1.0 / r_hi
    idx = int(np.clip(np.floor((u - spec.u0) / spec.h), 0,
                      spec.n_int - 1))
    return min(spec.n_basis, idx + 4)


def _switch_poly(r, r_lo: float, r_hi: float):
    """C^2 quintic smoothstep partition S(r): 1 below r_lo, 0 above
    r_hi.  Returns (S, dS/dr)."""
    width = r_hi - r_lo
    u = jnp.clip((r - r_lo) / width, 0.0, 1.0)
    u2 = u * u
    u3 = u2 * u
    s = 1.0 - (10.0 * u3 - 15.0 * u3 * u + 6.0 * u3 * u2)
    ds = -(30.0 * u2 - 60.0 * u3 + 30.0 * u2 * u2) / width
    return s, ds


@functools.partial(jax.jit,
                   static_argnames=("spec_pair", "n_basis_pair",
                                    "with_energy", "r_lo", "r_hi"))
def pair_short_forces(pair_coefficients, positions, cell, nbr3,
                      spec_pair: LegSpec = None,
                      n_basis_pair: int = 0,
                      with_energy: bool = True,
                      r_lo: float = 0.0,
                      r_hi: float = 0.0,
                      cache3: Optional[ForceCache] = None,
                      comps=None):
    """Innermost r-RESPA force (3-level split): the switched
    short-range 2-body V_short = S(r) V(r) alone, on the compact
    3-body list's rows.  Row-local -- every pair appears in both
    rows, so there is NO cross-atom assembly gather; together with
    trio_only_forces at the mid level and pair_tail_forces at the
    outer level this partitions the total force exactly
    (S + (1 - S) = 1 on pairs; the 3-body term is whole at the mid
    level).  ``comps`` (3-tuple of (N, K3)) reuses an existing
    displacement gather.  Returns (e_short, forces (N, 3), comps)."""
    dtype = positions.dtype
    n_atoms = positions.shape[0]
    if cache3 is None:
        cache3 = build_trio_cache(nbr3, cell, dtype)
    if comps is None:
        pj = gather_rows_blocks(positions, cache3.idx_flats, n_atoms)
        comps = tuple(pj[..., c] + cache3.sd[c]
                      - positions[:, c][:, None] for c in range(3))
    r2 = comps[0] ** 2 + comps[1] ** 2 + comps[2] ** 2
    r = jnp.sqrt(jnp.where(r2 > 0, r2, 1.0))
    valid2 = (cache3.valid
              * (r > spec_pair.t_min).astype(dtype)
              * (r < spec_pair.t_max).astype(dtype))
    # the value chain is needed regardless of with_energy: the
    # switched force carries the v2 * dS/dr term
    v2, dv2 = _pair_chain(r, spec_pair, pair_coefficients,
                          n_basis_pair, True)
    s, ds = _switch_poly(r, r_lo, r_hi)
    e_short = jnp.sum(v2 * s * valid2) if with_energy \
        else jnp.zeros((), dtype=dtype)
    w_pair = 2.0 * (dv2 * s + v2 * ds) * valid2 / r
    forces = jnp.stack([jnp.sum(w_pair * dc, axis=1)
                        for dc in comps], axis=-1)
    return e_short, forces, comps


@functools.partial(jax.jit,
                   static_argnames=("spec_pair", "n_basis_pair",
                                    "spec_l", "spec_n", "l_basis",
                                    "n_basis", "block_atoms",
                                    "with_energy", "active_bc",
                                    "window", "r_lo", "r_hi",
                                    "triangle"))
def trio_short_forces(pair_coefficients, grid,
                      positions, cell, nbr3,
                      spec_pair: LegSpec = None,
                      n_basis_pair: int = 0,
                      spec_l: LegSpec = None,
                      spec_n: LegSpec = None,
                      l_basis: int = 0,
                      n_basis: int = 0,
                      block_atoms: int = 512,
                      with_energy: bool = True,
                      active_bc=None,
                      window=None,
                      r_lo: float = 0.0,
                      r_hi: float = 0.0,
                      triangle: bool = False,
                      cache3: Optional[ForceCache] = None):
    """RESPA inner force: 3-body + switched short-range 2-body
    (V_short = S(r) V(r)), both evaluated on the compact 3-body list's
    displacements -- one (N, K3) gather instead of the (N, K2) pair
    gather.  Valid because every pair with r < r_hi <= r_cut_3b is in
    the 3-body list by the same Verlet-skin argument that makes the
    trio legs complete.  Returns (e_short2, e3_atoms, forces)."""
    dtype = positions.dtype
    n_atoms, k3 = nbr3.idx.shape
    triangle = triangle and k3 >= 2
    if cache3 is None:
        cache3 = build_trio_cache(nbr3, cell, dtype)
    pj = gather_rows_blocks(positions, cache3.idx_flats, n_atoms)
    comps3 = tuple(pj[..., c] + cache3.sd[c]
                   - positions[:, c][:, None] for c in range(3))
    r3sq = comps3[0] ** 2 + comps3[1] ** 2 + comps3[2] ** 2
    r3 = jnp.sqrt(jnp.where(r3sq > 0, r3sq, 1.0))
    # switched short-range pair on the same displacements
    valid2 = (cache3.valid
              * (r3 > spec_pair.t_min).astype(dtype)
              * (r3 < spec_pair.t_max).astype(dtype))
    v2, dv2 = _pair_chain(r3, spec_pair, pair_coefficients,
                          n_basis_pair, True)
    s, ds = _switch_poly(r3, r_lo, r_hi)
    e_short = jnp.sum(v2 * s * valid2) if with_energy \
        else jnp.zeros((), dtype=dtype)
    w_pair = 2.0 * (dv2 * s + v2 * ds) * valid2 / r3
    f2 = [jnp.sum(w_pair * dc, axis=1) for dc in comps3]
    # trio blocks
    pad = (-n_atoms) % block_atoms

    def blocks(a):
        return jnp.pad(a, ((0, pad), (0, 0))).reshape(
            -1, block_atoms, a.shape[1])

    c_blocks = tuple(blocks(dc) for dc in comps3)
    m_blocks = blocks(cache3.valid)
    p_blocks = blocks(cache3.pair_pre)

    def block_fn(args):
        cx, cy, cz, m_b, p_b = args
        if triangle:
            energy, f_center, s1, s3, v3 = _trio_block_compute_tri(
                (cx, cy, cz), m_b, grid, spec_l, spec_n, l_basis,
                n_basis, with_energy=with_energy,
                active_bc=active_bc, window=window)
        else:
            energy, f_center, s1, s3, v3 = _trio_block_compute(
                (cx, cy, cz), m_b, grid, spec_l, spec_n, l_basis,
                n_basis, with_energy=with_energy,
                active_bc=active_bc, window=window, pair_pre=p_b)
        return (energy, jnp.stack(f_center, axis=-1),
                _pack_partials(s1, s3, v3))

    energy, f_center, packed = jax.lax.map(
        block_fn, c_blocks + (m_blocks, p_blocks))
    energy = energy.reshape(-1)[:n_atoms]
    f_center = f_center.reshape(-1, 3)[:n_atoms]
    packed = packed.reshape(-1, k3 * 8)[:n_atoms]
    e3, f3 = _assemble_forces(energy, f_center, packed, comps3, r3,
                              cache3)
    forces = jnp.stack([f2[c] + f3[:, c] for c in range(3)], axis=-1)
    return e_short, e3, forces


@functools.partial(jax.jit,
                   static_argnames=("spec_pair", "n_basis_pair",
                                    "with_energy", "r_lo", "r_hi"))
def pair_tail_forces(pair_coefficients, positions, cell, nbr2,
                     spec_pair: LegSpec = None,
                     n_basis_pair: int = 0,
                     with_energy: bool = True,
                     r_lo: float = 0.0,
                     r_hi: float = 0.0,
                     cache2: Optional[ForceCache] = None):
    """RESPA outer force: the complementary long-range 2-body tail
    V_tail = (1 - S(r)) V(r) on the full pair list.  Smooth and slow
    by construction (r > r_lo), so it integrates stably on the outer
    timestep.  Returns (e_tail, forces)."""
    dtype = positions.dtype
    n_atoms = positions.shape[0]
    if cache2 is None:
        cache2 = build_pair_cache(nbr2.idx, nbr2.shift, nbr2.mask,
                                  cell, dtype)
    pj = gather_rows_blocks(positions, cache2.idx_flats, n_atoms)
    comps2 = tuple(pj[..., c] + cache2.sd[c]
                   - positions[:, c][:, None] for c in range(3))
    r2sq = comps2[0] ** 2 + comps2[1] ** 2 + comps2[2] ** 2
    r2 = jnp.sqrt(jnp.where(r2sq > 0, r2sq, 1.0))
    valid2 = (cache2.valid
              * (r2 > spec_pair.t_min).astype(dtype)
              * (r2 < spec_pair.t_max).astype(dtype))
    v2, dv2 = _pair_chain(r2, spec_pair, pair_coefficients,
                          n_basis_pair, True)
    s, ds = _switch_poly(r2, r_lo, r_hi)
    e_tail = jnp.sum(v2 * (1.0 - s) * valid2) if with_energy \
        else jnp.zeros((), dtype=dtype)
    w_pair = 2.0 * (dv2 * (1.0 - s) - v2 * ds) * valid2 / r2
    forces = jnp.stack([jnp.sum(w_pair * dc, axis=1)
                        for dc in comps2], axis=-1)
    return e_tail, forces


# ---------------------------------------------------------------------------
# shared-gather fused step: ONE (N, K2) neighbor-position gather feeds
# both the 2-body kernel and -- via the parent-slot selection the
# filtered 3-body list carries (NeighborList.sel) -- the 3-body pair-
# lane kernel, in place of a separate (N, K3) trio position gather.
# Whether the one-hot selection beats that gather on the GPU is not
# measured yet (MDSystem fused="separate" runs the other route).
# ---------------------------------------------------------------------------
@functools.partial(jax.jit,
                   static_argnames=("spec_pair", "n_basis_pair",
                                    "spec_l", "spec_n", "l_basis",
                                    "n_basis", "block_atoms",
                                    "with_energy", "with_virial",
                                    "active_bc", "window",
                                    "triangle"))
def pair_trio_forces_shared(pair_coefficients, grid,
                            positions, cell, nbr2, nbr3,
                            spec_pair: LegSpec = None,
                            n_basis_pair: int = 0,
                            spec_l: LegSpec = None,
                            spec_n: LegSpec = None,
                            l_basis: int = 0,
                            n_basis: int = 0,
                            block_atoms: int = 512,
                            with_energy: bool = True,
                            with_virial: bool = False,
                            active_bc=None,
                            window=None,
                            triangle: bool = False,
                            cache2: Optional[ForceCache] = None,
                            cache3: Optional[ForceCache] = None):
    """Fused unary 2+3-body energy/forces (+ Voigt virial) with a
    single neighbor-position gather.  Requires nbr3 derived from nbr2
    by filter_neighbor_list (nbr3.sel maps trio slots to parent pair
    slots, so trio displacements are selected, not re-gathered).

    Returns (e2_sum, e3_atoms, forces, virial6 | None)."""
    dtype = positions.dtype
    n_atoms, k2 = nbr2.idx.shape
    k3 = nbr3.idx.shape[1]
    triangle = triangle and k3 >= 2
    if cache2 is None:
        cache2 = build_pair_cache(nbr2.idx, nbr2.shift, nbr2.mask,
                                  cell, dtype)
    if cache3 is None:
        cache3 = build_trio_cache(nbr3, cell, dtype)
    pj = gather_rows_blocks(positions, cache2.idx_flats, n_atoms)
    comps2 = tuple(pj[..., c] + cache2.sd[c]
                   - positions[:, c][:, None] for c in range(3))
    r2sq = comps2[0] ** 2 + comps2[1] ** 2 + comps2[2] ** 2
    r2 = jnp.sqrt(jnp.where(r2sq > 0, r2sq, 1.0))
    # ---- 2-body ------------------------------------------------------
    valid2 = (cache2.valid
              * (r2 > spec_pair.t_min).astype(dtype)
              * (r2 < spec_pair.t_max).astype(dtype))
    v2, dv2 = _pair_chain(r2, spec_pair, pair_coefficients,
                          n_basis_pair, with_energy)
    e2 = jnp.sum(v2 * valid2) if with_energy \
        else jnp.zeros((), dtype=dtype)
    w_pair = 2.0 * dv2 * valid2 / r2
    f2 = [jnp.sum(w_pair * dc, axis=1) for dc in comps2]
    v6_pair = None
    if with_virial:
        w_v = 0.5 * w_pair
        v6_pair = jnp.stack([jnp.sum(w_v * comps2[a] * comps2[b])
                             for a, b in VOIGT_AB])
    # ---- 3-body: select trio displacements from the pair rows -------
    comps3 = select_minor(comps2, nbr3.sel.astype(jnp.int32), k2)
    r3sq = comps3[0] ** 2 + comps3[1] ** 2 + comps3[2] ** 2
    r3 = jnp.sqrt(jnp.where(r3sq > 0, r3sq, 1.0))
    pad = (-n_atoms) % block_atoms

    def blocks(a):
        return jnp.pad(a, ((0, pad), (0, 0))).reshape(
            -1, block_atoms, a.shape[1])

    c_blocks = tuple(blocks(dc) for dc in comps3)
    m_blocks = blocks(cache3.valid)
    p_blocks = blocks(cache3.pair_pre)

    def block_fn(args):
        cx, cy, cz, m_b, p_b = args
        if triangle:
            out = _trio_block_compute_tri(
                (cx, cy, cz), m_b, grid, spec_l, spec_n, l_basis,
                n_basis, with_energy=with_energy,
                with_virial=with_virial, active_bc=active_bc,
                window=window)
        else:
            out = _trio_block_compute(
                (cx, cy, cz), m_b, grid, spec_l, spec_n, l_basis,
                n_basis, with_energy=with_energy,
                with_virial=with_virial, active_bc=active_bc,
                window=window, pair_pre=p_b)
        energy, f_center, s1, s3, v3 = out[:5]
        packed = (energy, jnp.stack(f_center, axis=-1),
                  _pack_partials(s1, s3, v3))
        return packed + (out[5],) if with_virial else packed

    outs = jax.lax.map(block_fn, c_blocks + (m_blocks, p_blocks))
    e3_atoms = outs[0].reshape(-1)[:n_atoms]
    f_center = outs[1].reshape(-1, 3)[:n_atoms]
    packed = outs[2].reshape(-1, k3 * 8)[:n_atoms]
    e3_atoms, f3 = _assemble_forces(e3_atoms, f_center, packed,
                                    comps3, r3, cache3)
    forces = jnp.stack([f2[c] + f3[:, c] for c in range(3)], axis=-1)
    if with_virial:
        return e2, e3_atoms, forces, v6_pair + jnp.sum(outs[3],
                                                       axis=0)
    return e2, e3_atoms, forces, None
