"""
Direct parity tests for the fused single-type kernels in
uf3_tpu/ops/pallas_trio.py against the factorized device potential
(itself validated against the host calculator oracle).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from uf3_tpu.data.atoms import bulk
from uf3_tpu.ops import neighbors as nb
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops import potential as pot
from uf3_tpu.regression import least_squares as ls


@pytest.fixture(scope="module")
def w_model():
    return ls.WeightedLinearModel.from_json(
        os.path.join("benchmarks_data", "model_2and3.json"))


@pytest.fixture(scope="module")
def w_setup(w_model):
    geom = bulk("W", "bcc", a=3.1652) * 4
    geom.rattle(0.05, seed=11)
    params = pot.params_from_model(w_model, dtype=jnp.float64)
    pos = jnp.asarray(geom.positions)
    cell = jnp.asarray(geom.cell)
    species = params.z_to_species[jnp.asarray(geom.numbers)]
    nbr2 = nb.build_neighbor_list(pos, cell, geom.pbc,
                                  float(params.r_cut_2b), 64,
                                  with_rev=False)
    nbr3 = nb.build_neighbor_list(pos, cell, geom.pbc,
                                  float(params.r_cut_3b), 24)
    e_ref, f_ref, _ = pot.compute_energy_forces(
        params, species, pos, cell, nbr2, nbr3)
    return geom, params, pos, cell, nbr2, nbr3, e_ref, f_ref


class TestPairKernels:
    def _pair_only_ref(self, w_setup):
        geom, params, pos, cell, nbr2, _, _, _ = w_setup
        species = params.z_to_species[jnp.asarray(geom.numbers)]
        e, f, _ = pot.compute_energy_forces(params, species, pos, cell,
                                            nbr2, None)
        e1 = float(jnp.sum(params.offsets_1b[species]))
        return float(e) - e1, np.asarray(f)

    def test_unrolled_matches_factorized(self, w_model, w_setup):
        geom, params, pos, cell, nbr2, _, _, _ = w_setup
        e_ref, f_ref = self._pair_only_ref(w_setup)
        spec, coeff = pt.build_pair_fast(w_model, dtype=jnp.float64)
        e, f = pt.pair_forces_unrolled(coeff, pos, cell, nbr2.idx,
                                       nbr2.shift, nbr2.mask,
                                       spec=spec, n_basis=spec.n_basis)
        assert np.isclose(float(e), e_ref, atol=1e-10)
        assert np.allclose(np.asarray(f), f_ref, atol=1e-10)

    def test_poly_matches_factorized(self, w_model, w_setup):
        geom, params, pos, cell, nbr2, _, _, _ = w_setup
        e_ref, f_ref = self._pair_only_ref(w_setup)
        spec, table = pt.build_pair_poly(w_model, dtype=jnp.float64)
        e, f = pt.pair_forces_poly(table, pos, cell, nbr2.idx,
                                   nbr2.shift, nbr2.mask, spec=spec)
        assert np.isclose(float(e), e_ref, atol=1e-9)
        assert np.allclose(np.asarray(f), f_ref, atol=1e-9)
        # forces-only variant elides the energy chain
        e0, f0 = pt.pair_forces_poly(table, pos, cell, nbr2.idx,
                                     nbr2.shift, nbr2.mask, spec=spec,
                                     with_energy=False)
        assert float(e0) == 0.0
        assert np.allclose(np.asarray(f0), f_ref, atol=1e-9)


class TestCardinalBasis:
    def test_cardinal_coefficients_roundtrip(self):
        # random clamped spline on uniform knots == its cardinal
        # re-expression, everywhere on the domain incl. derivatives
        rng = np.random.RandomState(7)
        n_int = 12
        lo, hi = 1.0, 5.5
        pts = np.linspace(lo, hi, n_int + 1)
        seq = np.concatenate([[lo] * 3, pts, [hi] * 3])
        coef = rng.randn(n_int + 3)
        uc = pt.cardinal_coefficients(seq, coef)
        assert uc is not None
        ok, spec = pt.leg_spec_from_knots(seq)
        assert ok and spec.kind == pt.LINEAR
        spec_c = spec._replace(cardinal=True)
        r = jnp.asarray(np.linspace(lo + 1e-9, hi - 1e-9, 507))
        # clamped evaluation via de Boor
        idx = pt._leg_interval(spec, r)
        vals, ders = pt._deboor4(r, idx, spec)
        v_ref = sum(vals[t] * jnp.asarray(coef)[idx + t]
                    for t in range(4))
        d_ref = sum(ders[t] * jnp.asarray(coef)[idx + t]
                    for t in range(4))
        cvals, cders, cidx = pt._cardinal4(r, spec_c)
        ucj = jnp.asarray(uc)
        v = sum(cvals[t] * ucj[cidx + t] for t in range(4))
        d = sum(cders[t] * ucj[cidx + t] for t in range(4))
        assert np.allclose(np.asarray(v), np.asarray(v_ref), atol=1e-10)
        assert np.allclose(np.asarray(d), np.asarray(d_ref), atol=1e-9)

    def test_cardinal_rejects_nonuniform(self):
        pts = np.array([1.0, 2.0, 3.5, 4.0, 5.5])
        seq = np.concatenate([[1.0] * 3, pts, [5.5] * 3])
        assert pt.cardinal_coefficients(seq, np.ones(7)) is None


class TestTrioKernel:
    def test_active_bc_matches_dense(self, w_model, w_setup):
        # static zero-block skipping must be exact: the skipped (b, c)
        # blocks have all-zero grid columns
        geom, params, pos, cell, nbr2, nbr3, e_ref, f_ref = w_setup
        bundle = pt.build_trio_bundle(w_model, dtype=jnp.float64)
        n_active = sum(len(cs) for _, cs in bundle.active_bc)
        assert n_active < bundle.grid.shape[1] * bundle.grid.shape[2]
        dense = pt.trio_forces_unrolled(
            bundle.grid, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, spec_l=bundle.spec_l, spec_n=bundle.spec_n,
            l_basis=bundle.l_basis, n_basis=bundle.n_basis,
            block_atoms=64)
        sparse = pt.trio_forces_unrolled(
            bundle.grid, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, spec_l=bundle.spec_l, spec_n=bundle.spec_n,
            l_basis=bundle.l_basis, n_basis=bundle.n_basis,
            block_atoms=64, active_bc=bundle.active_bc)
        assert np.allclose(np.asarray(dense[0]), np.asarray(sparse[0]),
                           atol=1e-12)
        assert np.allclose(np.asarray(dense[1]), np.asarray(sparse[1]),
                           atol=1e-12)

    def test_block_padding_invariant(self, w_model, w_setup):
        # 128 atoms in blocks of 24 pad the last block with 16 empty
        # rows: padding must contribute nothing
        geom, params, pos, cell, nbr2, nbr3, e_ref, f_ref = w_setup
        bundle = pt.build_trio_bundle(w_model, dtype=jnp.float64)
        kw = dict(spec_l=bundle.spec_l, spec_n=bundle.spec_n,
                  l_basis=bundle.l_basis, n_basis=bundle.n_basis,
                  active_bc=bundle.active_bc, window=bundle.window)
        whole = pt.trio_forces_unrolled(
            bundle.grid, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, block_atoms=64, **kw)
        padded = pt.trio_forces_unrolled(
            bundle.grid, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, block_atoms=24, **kw)
        assert np.allclose(np.asarray(whole[0]), np.asarray(padded[0]),
                           atol=1e-12)
        assert np.allclose(np.asarray(whole[1]), np.asarray(padded[1]),
                           atol=1e-12)

    def test_unrolled_matches_factorized(self, w_model, w_setup):
        geom, params, pos, cell, nbr2, nbr3, e_ref, f_ref = w_setup
        bundle = pt.build_trio_bundle(w_model, dtype=jnp.float64)
        spec, coeff = pt.build_pair_fast(w_model, dtype=jnp.float64)
        e2, f2 = pt.pair_forces_unrolled(coeff, pos, cell, nbr2.idx,
                                         nbr2.shift, nbr2.mask,
                                         spec=spec,
                                         n_basis=spec.n_basis)
        e3, f3 = pt.trio_forces_unrolled(
            bundle.grid, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, spec_l=bundle.spec_l, spec_n=bundle.spec_n,
            l_basis=bundle.l_basis, n_basis=bundle.n_basis,
            block_atoms=64)
        species = params.z_to_species[jnp.asarray(geom.numbers)]
        e1 = float(jnp.sum(params.offsets_1b[species]))
        assert np.isclose(e1 + float(e2) + float(jnp.sum(e3)),
                          float(e_ref), atol=1e-9)
        assert np.allclose(np.asarray(f2 + f3), np.asarray(f_ref),
                           atol=1e-9)

    @pytest.mark.parametrize("triangle", [False, True])
    def test_center_weight_virial_partition(self, w_model, w_setup,
                                            triangle):
        """The halo seam: the virial is a sum of per-center terms, so
        an ownership partition w + (1-w) must reproduce the unweighted
        virial exactly (this is what makes the sharded-NPT psum of
        owner-weighted virials exact)."""
        geom, params, pos, cell, nbr2, nbr3, e_ref, f_ref = w_setup
        bundle = pt.build_trio_bundle(w_model, dtype=jnp.float64)
        kw = dict(spec_l=bundle.spec_l, spec_n=bundle.spec_n,
                  l_basis=bundle.l_basis, n_basis=bundle.n_basis,
                  block_atoms=64, with_virial=True, triangle=triangle)
        e_all, f_all, v_all = pt.trio_forces_unrolled(
            bundle.grid, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, **kw)
        rng = np.random.RandomState(7)
        w = jnp.asarray(rng.randint(0, 2, pos.shape[0]),
                        dtype=jnp.float64)
        parts = [pt.trio_forces_unrolled(
            bundle.grid, pos, cell, nbr3.idx, nbr3.shift, nbr3.mask,
            nbr3.rev, center_weight=wi, **kw) for wi in (w, 1.0 - w)]
        v_sum = np.asarray(parts[0][2]) + np.asarray(parts[1][2])
        e_sum = float(jnp.sum(parts[0][0]) + jnp.sum(parts[1][0]))
        assert np.allclose(v_sum, np.asarray(v_all), atol=1e-10)
        assert np.isclose(e_sum, float(jnp.sum(e_all)), atol=1e-10)
