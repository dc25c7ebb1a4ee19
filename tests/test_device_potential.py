"""
Device-engine tests (JAX CPU x64): neighbor lists, scatter-free
energy/force/virial vs the host calculator oracle, and MD integrators.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uf3_tpu.data.atoms import Atoms, bulk
from uf3_tpu.forcefield.calculator import UFCalculator
from uf3_tpu.forcefield.md import MDSystem
from uf3_tpu.ops import neighbors as nb
from uf3_tpu.ops import potential as pot
from uf3_tpu.regression import least_squares as ls


@pytest.fixture(scope="module")
def unary_model(data_dir):
    return ls.WeightedLinearModel.from_json(
        os.path.join(data_dir, "model_unary.json"))


@pytest.fixture(scope="module")
def rattled_bcc():
    geom = bulk("W", "bcc", a=3.16) * 4
    geom.rattle(0.05, seed=3)
    return geom


class TestNeighborList:
    def test_counts_match_bruteforce(self, rattled_bcc):
        geom = rattled_bcc
        pos = jnp.asarray(geom.positions)
        cell = jnp.asarray(geom.cell)
        r_cut = 4.0
        nbr = nb.build_neighbor_list(pos, cell, geom.pbc, r_cut, 48)
        assert not bool(nbr.overflow)
        # brute-force MIC count
        frac = geom.positions @ np.linalg.inv(geom.cell)
        diff = frac[None] - frac[:, None]
        diff -= np.round(diff)
        disp = diff @ geom.cell
        d = np.linalg.norm(disp, axis=-1)
        expected = np.sum((d < r_cut) & (d > 1e-6), axis=1)
        assert np.array_equal(np.asarray(jnp.sum(nbr.mask, axis=1)),
                              expected)

    def test_reverse_slots(self, rattled_bcc):
        geom = rattled_bcc
        pos = jnp.asarray(geom.positions)
        cell = jnp.asarray(geom.cell)
        nbr = nb.build_neighbor_list(pos, cell, geom.pbc, 4.0, 48)
        idx = np.asarray(nbr.idx)
        shift = np.asarray(nbr.shift)
        rev = np.asarray(nbr.rev)
        mask = np.asarray(nbr.mask)
        for a in range(0, len(geom), 17):
            for s in range(idx.shape[1]):
                if not mask[a, s]:
                    continue
                c = idx[a, s]
                p = rev[a, s]
                assert idx[c, p] == a
                assert np.allclose(shift[c, p], -shift[a, s])

    @staticmethod
    def _pair_set(nbr):
        idx = np.asarray(nbr.idx)
        shift = np.asarray(nbr.shift).astype(int)
        mask = np.asarray(nbr.mask)
        pairs = set()
        for a in range(idx.shape[0]):
            for s in range(idx.shape[1]):
                if mask[a, s]:
                    pairs.add((a, int(idx[a, s])) + tuple(shift[a, s]))
        return pairs

    @pytest.mark.parametrize("selection", ["pack", "pack2", "topk"])
    @pytest.mark.parametrize("displace", [False, True])
    def test_cell_list_matches_bruteforce(self, displace, selection):
        # the production MD path (>=512 atoms) uses the packed-key
        # cell-list builder; verify the (i, j, image) pair set equals
        # the O(N^2) minimum-image builder's, with atoms optionally
        # translated outside the primary cell (base-image path), for
        # both the prefix-sum-pack and top-k selection modes
        geom = bulk("W", "bcc", a=3.16) * (7, 7, 7)
        geom.rattle(0.1, seed=5)
        pos = np.array(geom.positions)
        if displace:
            rng = np.random.RandomState(0)
            pos += rng.randint(-2, 3, size=(len(geom), 3)) @ geom.cell
        pos = jnp.asarray(pos)
        cell = jnp.asarray(geom.cell)
        r_cut = 4.5
        ref = nb.build_neighbor_list(pos, cell, geom.pbc, r_cut, 48,
                                     with_rev=False)
        grid_shape = nb.grid_shape_for(geom.cell, r_cut, geom.pbc)
        cl = nb.build_neighbor_list_cells(
            pos, cell, geom.pbc, r_cut, 48, grid_shape,
            bin_capacity=24, with_rev=False, selection=selection)
        assert not bool(ref.overflow) and not bool(cl.overflow)
        assert self._pair_set(cl) == self._pair_set(ref)
        if not displace:
            # wrapped fast path: wrap first (rattle leaves boundary
            # atoms slightly outside the cell), then the pair set must
            # match the reference built on the same wrapped positions
            posw = nb.wrap_positions(pos, cell, geom.pbc)
            refw = nb.build_neighbor_list(posw, cell, geom.pbc, r_cut,
                                          48, with_rev=False)
            clw = nb.build_neighbor_list_cells(
                posw, cell, geom.pbc, r_cut, 48, grid_shape,
                bin_capacity=24, with_rev=False, assume_wrapped=True,
                selection=selection)
            assert self._pair_set(clw) == self._pair_set(refw)

    def test_pack2_bitwise_equals_pack(self):
        # the two-stage pack must reproduce the single-stage pack
        # EXACTLY (same stencil-major slot order, same overflow flag),
        # independent of the lax.map bin-block size
        geom = bulk("W", "bcc", a=3.16) * (7, 7, 7)
        geom.rattle(0.15, seed=11)
        pos = jnp.asarray(np.array(geom.positions))
        cell = jnp.asarray(geom.cell)
        r_cut = 4.5
        grid_shape = nb.grid_shape_for(geom.cell, r_cut, geom.pbc)
        kw = dict(grid_shape=grid_shape, bin_capacity=24)
        for cap in (48, 10):     # ample + deliberately overflowing
            ref = nb.build_neighbor_list_cells(
                pos, cell, geom.pbc, r_cut, cap, selection="pack",
                **kw)
            for bb in (None, 3, 64):
                got = nb.build_neighbor_list_cells(
                    pos, cell, geom.pbc, r_cut, cap,
                    selection="pack2", bin_block=bb, **kw)
                assert np.array_equal(np.asarray(ref.idx),
                                      np.asarray(got.idx))
                assert np.array_equal(np.asarray(ref.shift),
                                      np.asarray(got.shift))
                assert np.array_equal(np.asarray(ref.mask),
                                      np.asarray(got.mask))
                assert np.array_equal(np.asarray(ref.rev),
                                      np.asarray(got.rev))
                assert bool(ref.overflow) == bool(got.overflow)
            assert bool(ref.overflow) == (cap == 10)

    def test_wrap_positions_exact_translation(self):
        geom = bulk("W", "bcc", a=3.16) * 3
        geom.rattle(0.1, seed=2)
        rng = np.random.RandomState(1)
        shifts = rng.randint(-3, 4, size=(len(geom), 3))
        pos = jnp.asarray(geom.positions + shifts @ geom.cell)
        wrapped = np.asarray(nb.wrap_positions(
            pos, jnp.asarray(geom.cell), geom.pbc))
        # inside the primary cell ...
        frac = wrapped @ np.linalg.inv(geom.cell)
        assert np.all(frac >= -1e-9) and np.all(frac < 1.0 + 1e-9)
        # ... and displaced from the input by exact lattice vectors
        delta = (np.asarray(pos) - wrapped) @ np.linalg.inv(geom.cell)
        assert np.allclose(delta, np.round(delta), atol=1e-6)

    def test_needs_rebuild(self, rattled_bcc):
        geom = rattled_bcc
        pos = jnp.asarray(geom.positions)
        cell = jnp.asarray(geom.cell)
        nbr = nb.build_neighbor_list(pos, cell, geom.pbc, 4.0, 48)
        assert not bool(nb.needs_rebuild(nbr, pos, skin=0.5))
        # top-2-sum criterion: ONE atom drifting 0.3 cannot close a
        # 0.5 A pair gap (needs combined approach > skin) ...
        moved = pos.at[0, 0].add(0.3)
        assert not bool(nb.needs_rebuild(nbr, moved, skin=0.5))
        # ... but two atoms at 0.3 each can (sum 0.6 > 0.5)
        moved2 = moved.at[1, 0].add(-0.3)
        assert bool(nb.needs_rebuild(nbr, moved2, skin=0.5))
        # and a single atom can when it alone exceeds the whole skin
        moved3 = pos.at[0, 0].add(0.6)
        assert bool(nb.needs_rebuild(nbr, moved3, skin=0.5))


class TestDevicePotential:
    def test_matches_host_calculator(self, unary_model, rattled_bcc):
        geom = rattled_bcc
        calc = UFCalculator(unary_model)
        e_ref = calc.get_potential_energy(geom)
        f_ref = calc.get_forces(geom)
        params = pot.params_from_model(unary_model, dtype=jnp.float64)
        species = params.z_to_species[jnp.asarray(geom.numbers)]
        pos = jnp.asarray(geom.positions)
        cell = jnp.asarray(geom.cell)
        nbr2 = nb.build_neighbor_list(pos, cell, geom.pbc,
                                      float(params.r_cut_2b), 64)
        nbr3 = nb.build_neighbor_list(pos, cell, geom.pbc,
                                      float(params.r_cut_3b), 32)
        energy, forces, virial = pot.compute_energy_forces(
            params, species, pos, cell, nbr2, nbr3)
        assert np.isclose(float(energy), e_ref, atol=1e-9)
        assert np.allclose(np.asarray(forces), f_ref, atol=1e-10)
        # analytic virial stress vs numerical stress
        stress = np.asarray(pot.stress_voigt(virial, geom.get_volume()))
        stress_num = calc.get_stress(geom)
        assert np.allclose(stress, stress_num, atol=1e-6)

    def test_matches_host_binary(self, data_dir):
        model = ls.WeightedLinearModel.from_json(
            os.path.join(data_dir, "model_binary.json"))
        # binary Ne/Xe fcc-ish box, box > 2 * r_cut
        rng = np.random.RandomState(0)
        base = bulk("Ne", "fcc", a=5.2) * 4
        numbers = base.get_atomic_numbers()
        numbers[rng.rand(len(numbers)) > 0.5] = 54  # Xe
        geom = Atoms(numbers=numbers, positions=base.positions,
                     cell=base.cell, pbc=True)
        geom.rattle(0.08, seed=1)
        calc = UFCalculator(model)
        e_ref = calc.get_potential_energy(geom)
        f_ref = calc.get_forces(geom)
        params = pot.params_from_model(model, dtype=jnp.float64)
        species = params.z_to_species[jnp.asarray(geom.numbers)]
        pos = jnp.asarray(geom.positions)
        cell = jnp.asarray(geom.cell)
        nbr2 = nb.build_neighbor_list(pos, cell, geom.pbc,
                                      float(params.r_cut_2b), 80)
        energy, forces, _ = pot.compute_energy_forces(
            params, species, pos, cell, nbr2, None)
        assert np.isclose(float(energy), e_ref, atol=1e-9)
        assert np.allclose(np.asarray(forces), f_ref, atol=1e-10)


class TestMD:
    def test_nve_energy_conservation(self, data_dir):
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 4
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=10)
        state = system.init_state(temperature=600.0, seed=1)
        e0 = float(state.energy) + system.kinetic_energy(state)
        state = system.run(state, n_steps=100, dt_fs=1.0)
        e1 = float(state.energy) + system.kinetic_energy(state)
        assert not bool(state.stale)
        assert abs(e1 - e0) / len(geom) < 1e-4  # eV/atom drift

    def test_two_tier_skin_forces_stay_exact(self):
        """Two-tier rebuilds (big 2B skin + cheap 3B refilter): forces
        along a hot trajectory must keep matching the exact host
        calculator (the refiltered 3B list never drops a triplet)."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        two = MDSystem(model, geom, dtype=jnp.float64,
                       rebuild_every=4, skin=0.6, skin_2b=1.8)
        assert two.two_tier
        assert two._images_2b is not None  # small cell: explicit images
        calc = UFCalculator(model)
        state = two.init_state(temperature=900.0, seed=5)
        e0 = float(state.energy) + two.kinetic_energy(state)
        # hot NVE in short chunks so 3B refilters actually trigger
        for _ in range(12):
            state = two.run(state, n_steps=5, dt_fs=2.0)
        assert not bool(state.nbr2.overflow)
        snapshot = Atoms(numbers=geom.numbers,
                         positions=np.asarray(state.positions),
                         cell=geom.cell, pbc=True)
        f_calc = calc.get_forces(snapshot)
        assert np.allclose(np.asarray(state.forces), f_calc, atol=1e-9)
        assert np.isclose(float(state.energy),
                          calc.get_potential_energy(snapshot), atol=1e-9)
        e1 = float(state.energy) + two.kinetic_energy(state)
        assert abs(e1 - e0) / len(geom) < 2e-4  # NVE drift, eV/atom

    def test_small_cell_images_match_calculator(self):
        """MD on a cell smaller than 2 * cutoff must agree with the
        host ghost-supercell oracle (explicit-image neighbor list,
        including self-image pairs)."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 2  # 6.33 A box, r_cut 5.5
        geom.rattle(0.05, seed=9)
        system = MDSystem(model, geom, dtype=jnp.float64, skin=0.4)
        assert system._images_2b is not None
        state = system.init_state()
        calc = UFCalculator(model)
        assert np.allclose(np.asarray(state.forces),
                           calc.get_forces(geom), atol=1e-9)
        assert np.isclose(float(state.energy),
                          calc.get_potential_energy(geom), atol=1e-9)

    def test_langevin_thermostat(self):
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=10)
        state = system.init_state(temperature=900.0, seed=2)
        state = system.run(state, n_steps=300, dt_fs=2.0,
                           thermostat="langevin", temperature=300.0,
                           friction_ps=10.0)
        assert 150.0 < system.temperature(state) < 500.0

    def test_md_forces_match_calculator(self):
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 4
        geom.rattle(0.04, seed=7)
        system = MDSystem(model, geom, dtype=jnp.float64)
        state = system.init_state()
        calc = UFCalculator(model)
        f_ref = calc.get_forces(geom)
        assert np.allclose(np.asarray(state.forces), f_ref, atol=1e-9)
        assert np.isclose(float(state.energy),
                          calc.get_potential_energy(geom), atol=1e-9)


class TestNPT:
    def test_berendsen_pressure_coupling(self):
        """NPT at P=0 holds the equilibrium volume; applied pressure
        compresses the cell (Berendsen barostat direction + scale)."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        v0 = geom.get_volume()

        def run_npt(pressure):
            # Berendsen time constant ~ tau_p / (beta * B) with
            # B ~ 1.9 eV/A^3 for W: choose a tight coupling so the
            # short test run actually equilibrates
            system = MDSystem(model, geom, dtype=jnp.float64,
                              rebuild_every=5, skin=0.5)
            state = system.init_state(temperature=100.0, seed=4)
            state, cells = system.npt_run(
                state, n_steps=100, dt_fs=2.0, temperature=100.0,
                pressure=pressure, tau_p_fs=20.0, compressibility=0.2,
                barostat="berendsen")
            return float(np.abs(np.linalg.det(cells[-1])))

        v_zero = run_npt(0.0)
        assert abs(v_zero - v0) / v0 < 0.03  # near-equilibrium hold
        v_comp = run_npt(0.2)  # ~32 GPa in eV/A^3
        # expected ~P/B ~ 10% compression; require a clear response
        assert v_comp < 0.96 * v_zero

    def test_scr_npt_ensemble(self):
        """Per-step stochastic-cell-rescaling NPT: holds the
        equilibrium volume at P=0 and compresses under pressure, with
        the barostat integrated inside the jit chunk (no factorized
        fallback, no per-chunk Berendsen rescale)."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        v0 = geom.get_volume()

        def run_npt(pressure):
            system = MDSystem(model, geom, dtype=jnp.float64,
                              rebuild_every=5, skin=0.5)
            state = system.init_state(temperature=100.0, seed=6)
            state, cells = system.npt_run(
                state, n_steps=120, dt_fs=2.0, temperature=100.0,
                pressure=pressure, tau_p_fs=40.0,
                compressibility=0.2, barostat="scr")
            # average the tail to smooth the stochastic term
            tail = [float(np.abs(np.linalg.det(c)))
                    for c in cells[-6:]]
            return float(np.mean(tail))

        v_zero = run_npt(0.0)
        assert abs(v_zero - v0) / v0 < 0.04
        v_comp = run_npt(0.2)
        assert v_comp < 0.97 * v_zero

    def test_triangle_kernel_exact(self):
        """The triangle-lane trio kernel (strict m < n lanes + g2
        mirror chain) must reproduce the full ordered-lane kernel
        exactly for the symmetric unary grid, including the virial."""
        from uf3_tpu.ops import pallas_trio as pt
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        geom.rattle(0.05, seed=17)
        system = MDSystem(model, geom, dtype=jnp.float64)
        tb = system.trio_bundle
        assert tb.symmetric
        state = system.init_state()
        n3 = state.nbr3
        args = (tb.grid, state.positions, system.cell, n3.idx,
                n3.shift, n3.mask, n3.rev)
        kw = dict(spec_l=tb.spec_l, spec_n=tb.spec_n,
                  l_basis=tb.l_basis, n_basis=tb.n_basis,
                  active_bc=tb.active_bc, window=tb.window,
                  with_virial=True)
        e_a, f_a, v_a = pt.trio_forces_unrolled(*args, triangle=False,
                                                **kw)
        e_b, f_b, v_b = pt.trio_forces_unrolled(*args, triangle=True,
                                                **kw)
        assert np.allclose(np.asarray(e_a), np.asarray(e_b),
                           atol=1e-10)
        assert np.allclose(np.asarray(f_a), np.asarray(f_b),
                           atol=1e-10)
        assert np.allclose(np.asarray(v_a), np.asarray(v_b),
                           atol=1e-9)

    def test_respa_force_split_exact(self):
        """The RESPA short/tail partition must reconstruct the full
        force field exactly: S(r) + (1 - S(r)) = 1 pointwise."""
        from uf3_tpu.ops import pallas_trio as pt
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        geom.rattle(0.04, seed=13)
        system = MDSystem(model, geom, dtype=jnp.float64, n_respa=3)
        state = system.init_state()
        x = state.positions
        e_full, f_full, _ = system.energy_forces(x, state.nbr2,
                                                 state.nbr3)
        spec_pair, pair_coeff = system.pair_fast
        tb = system.trio_bundle
        r_lo, r_hi = system.respa_switch
        e2s, e3, f_s = pt.trio_short_forces(
            pair_coeff, tb.grid, x, system.cell, state.nbr3,
            spec_pair=spec_pair, n_basis_pair=spec_pair.n_basis,
            spec_l=tb.spec_l, spec_n=tb.spec_n, l_basis=tb.l_basis,
            n_basis=tb.n_basis, active_bc=tb.active_bc,
            window=tb.window, r_lo=r_lo, r_hi=r_hi)
        e2t, f_t = pt.pair_tail_forces(
            pair_coeff, x, system.cell, state.nbr2,
            spec_pair=spec_pair, n_basis_pair=spec_pair.n_basis,
            r_lo=r_lo, r_hi=r_hi)
        e1 = float(jnp.sum(system.params.offsets_1b[system.species]))
        e_split = e1 + float(e2s) + float(e2t) + float(jnp.sum(e3))
        assert np.isclose(e_split, float(e_full), atol=1e-9)
        assert np.allclose(np.asarray(f_s + f_t), np.asarray(f_full),
                           atol=1e-9)

    def test_respa_nve_drift(self):
        """r-RESPA NVE: energy drift stays bounded at n_respa=3."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=12, n_respa=3)
        state = system.init_state(temperature=600.0, seed=1)
        e0 = float(state.energy) + system.kinetic_energy(state)
        state = system.run(state, n_steps=120, dt_fs=1.0)
        e1 = float(state.energy) + system.kinetic_energy(state)
        assert abs(e1 - e0) / len(geom) < 2e-4  # eV/atom drift

    def test_respa3l_force_split_exact(self):
        """The 3-level RESPA partition (switched short pair / trio /
        tail) must reconstruct the full force field exactly."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        geom.rattle(0.04, seed=13)
        system = MDSystem(model, geom, dtype=jnp.float64, n_respa=4,
                          respa_mid=2)
        state = system.init_state()
        e_full, f_full, _ = system.energy_forces(
            state.positions, state.nbr2, state.nbr3)
        f_ps, f_mid, f_tail = system._respa_split_forces_3l(state)
        assert np.allclose(np.asarray(f_ps + f_mid + f_tail),
                           np.asarray(f_full), atol=1e-9)

    def test_respa3l_nve_drift(self):
        """3-level r-RESPA NVE: energy drift stays bounded with the
        trio force on a 2x mid timestep."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=12, n_respa=4, respa_mid=2)
        state = system.init_state(temperature=600.0, seed=1)
        e0 = float(state.energy) + system.kinetic_energy(state)
        state = system.run(state, n_steps=120, dt_fs=1.0)
        e1 = float(state.energy) + system.kinetic_energy(state)
        assert abs(e1 - e0) / len(geom) < 2e-4  # eV/atom drift

    def test_static_rebuild_matches_adaptive(self):
        """static_rebuild=True (unconditional full rebuild each cycle)
        must follow the adaptive-trigger trajectory: both schedules
        keep every within-cutoff pair listed, so forces agree up to
        summation order."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * (8, 8, 8)
        kw = dict(dtype=jnp.float64, rebuild_every=12, skin=0.5,
                  skin_2b=1.2, capacity_2b=72, capacity_3b=16,
                  n_respa=6, respa_mid=3, respa_switch=(2.5, 3.5))
        sys_a = MDSystem(model, geom, **kw)
        sys_s = MDSystem(model, geom, static_rebuild=True, **kw)
        st_a = sys_a.init_state(temperature=300.0, seed=3)
        st_s = sys_s.init_state(temperature=300.0, seed=3)
        st_a = sys_a.run(st_a, n_steps=36, dt_fs=2.0)
        st_s = sys_s.run(st_s, n_steps=36, dt_fs=2.0)
        # static rebuild wraps into the primary cell every cycle, the
        # adaptive path only on full rebuilds: compare modulo lattice
        # translations
        d = (np.asarray(st_a.positions) - np.asarray(st_s.positions)) \
            @ np.linalg.inv(np.asarray(geom.cell))
        d -= np.round(d)
        err = np.abs(d @ np.asarray(geom.cell)).max()
        assert err < 1e-8, err
        assert not sys_s.overflowed(st_s)

    def test_respa3l_launch_chunks_exact(self):
        """launch_chunks > 1 must reproduce the per-cycle-launch
        trajectory exactly on the 3-level RESPA path too."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        kw = dict(dtype=jnp.float64, rebuild_every=12, n_respa=4,
                  respa_mid=2)
        run_kw = dict(n_steps=96, dt_fs=1.0, thermostat="langevin",
                      temperature=500.0)
        sys_a = MDSystem(model, geom, **kw)
        st_a = sys_a.run(sys_a.init_state(temperature=500.0, seed=7),
                         **run_kw)
        sys_b = MDSystem(model, geom, **kw)
        st_b = sys_b.run(sys_b.init_state(temperature=500.0, seed=7),
                         launch_chunks=4, **run_kw)
        assert np.allclose(np.asarray(st_a.positions),
                           np.asarray(st_b.positions), atol=1e-12)
        assert np.allclose(np.asarray(st_a.velocities),
                           np.asarray(st_b.velocities), atol=1e-12)
        assert np.isclose(float(st_a.energy), float(st_b.energy),
                          atol=1e-10)

    def test_respa3l_validation(self):
        """respa_mid must divide n_respa and require n_respa > 1."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 2
        with pytest.raises(ValueError, match="multiple of respa_mid"):
            MDSystem(model, geom, n_respa=4, respa_mid=3)
        with pytest.raises(ValueError, match="requires n_respa"):
            MDSystem(model, geom, n_respa=1, respa_mid=2)

    def test_launch_chunks_exact(self):
        """Scanning whole rebuild cycles inside one jit launch
        (launch_chunks > 1) must reproduce the per-cycle-launch
        trajectory exactly: same rebuild cadence, same RNG stream,
        same carried split forces."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        kw = dict(dtype=jnp.float64, rebuild_every=12, n_respa=3)
        run_kw = dict(n_steps=72, dt_fs=1.0, thermostat="langevin",
                      temperature=500.0)
        sys_a = MDSystem(model, geom, **kw)
        st_a = sys_a.run(sys_a.init_state(temperature=500.0, seed=7),
                         **run_kw)
        sys_b = MDSystem(model, geom, **kw)
        st_b = sys_b.run(sys_b.init_state(temperature=500.0, seed=7),
                         launch_chunks=3, **run_kw)
        assert np.allclose(np.asarray(st_a.positions),
                           np.asarray(st_b.positions), atol=1e-12)
        assert np.allclose(np.asarray(st_a.velocities),
                           np.asarray(st_b.velocities), atol=1e-12)

    def test_launch_chunks_exact_nonrespa(self):
        """The non-RESPA chunk path (n_respa=1) must also reproduce
        the per-cycle-launch trajectory exactly under launch_chunks."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        kw = dict(dtype=jnp.float64, rebuild_every=12)
        run_kw = dict(n_steps=48, dt_fs=1.0, thermostat="langevin",
                      temperature=500.0)
        sys_a = MDSystem(model, geom, **kw)
        st_a = sys_a.run(sys_a.init_state(temperature=500.0, seed=7),
                         **run_kw)
        sys_b = MDSystem(model, geom, **kw)
        st_b = sys_b.run(sys_b.init_state(temperature=500.0, seed=7),
                         launch_chunks=4, **run_kw)
        assert np.allclose(np.asarray(st_a.positions),
                           np.asarray(st_b.positions), atol=1e-12)
        assert np.allclose(np.asarray(st_a.velocities),
                           np.asarray(st_b.velocities), atol=1e-12)
        assert np.isclose(float(st_a.energy), float(st_b.energy),
                          atol=1e-10)

    def test_npt_launch_chunks_exact(self):
        """NPT stochastic-cell-rescaling with launch_chunks > 1 must
        reproduce the per-cycle-launch trajectory and cell exactly
        (the melting protocol must not be dispatch-bound)."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        kw = dict(dtype=jnp.float64, rebuild_every=12)
        npt_kw = dict(n_steps=48, dt_fs=1.0, temperature=500.0,
                      pressure=0.0)
        sys_a = MDSystem(model, geom, **kw)
        st_a, _ = sys_a.npt_run(
            sys_a.init_state(temperature=500.0, seed=7), **npt_kw)
        sys_b = MDSystem(model, geom, **kw)
        st_b, cells_b = sys_b.npt_run(
            sys_b.init_state(temperature=500.0, seed=7),
            launch_chunks=4, **npt_kw)
        assert np.allclose(np.asarray(st_a.positions),
                           np.asarray(st_b.positions), atol=1e-12)
        assert np.allclose(np.asarray(st_a.cell),
                           np.asarray(st_b.cell), atol=1e-12)
        assert len(cells_b) == 1

    def test_launch_chunks_overflow_sticky(self):
        """An overflow in an EARLY in-launch cycle must survive later
        in-launch rebuilds and surface to the host poll."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=2, n_respa=2, skin=0.4)
        state = system.init_state(temperature=10.0, seed=3)
        center = jnp.mean(state.positions, axis=0)
        state = state._replace(
            positions=center + 0.78 * (state.positions - center))
        out = system.run(state, n_steps=8, dt_fs=0.1,
                         launch_chunks=4, sync=False,
                         on_overflow="warn", check_every=10**6)
        assert system.overflowed(out)

    def test_fused_virial_matches_factorized(self):
        """The analytic virial emitted by the fused pair+trio kernels
        must equal the factorized oracle's (f64)."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        geom.rattle(0.05, seed=11)
        system = MDSystem(model, geom, dtype=jnp.float64)
        assert system.trio_bundle is not None  # unary fused path
        state = system.init_state()
        e_fused, f_fused, v_fused = system.energy_forces(
            state.positions, state.nbr2, state.nbr3,
            with_virial=True)
        e_ref, f_ref, v_ref = system.energy_forces_virial(
            state.positions, state.nbr2, state.nbr3)
        assert v_fused is not None
        assert np.allclose(np.asarray(v_fused), np.asarray(v_ref),
                           atol=1e-9)
        assert np.isclose(float(e_fused), float(e_ref), atol=1e-9)
        assert np.allclose(np.asarray(f_fused), np.asarray(f_ref),
                           atol=1e-9)

    def _overflowing_state(self):
        """System + state whose next neighbor rebuild overflows: the
        positions are compressed 0.78x (density ~2.1x) after init, so
        the first chunk's rebuild exceeds the init-sized capacity."""
        model = ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))
        geom = bulk("W", "bcc", a=3.1652) * 3
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=1, skin=0.4)
        state = system.init_state(temperature=10.0, seed=3)
        center = jnp.mean(state.positions, axis=0)
        squeezed = center + 0.78 * (state.positions - center)
        return system, state._replace(positions=squeezed)

    def test_run_raises_on_overflow(self):
        """Silent pair truncation cannot survive a (default, sync)
        run() call: every flag queued by the run is drained before it
        returns, so the RuntimeError fires from the call that
        overflowed."""
        system, state = self._overflowing_state()
        with pytest.raises(RuntimeError, match="capacity exceeded"):
            system.run(state, n_steps=2, dt_fs=0.1)

    def test_run_async_raises_at_next_call(self):
        """sync=False keeps the pipeline asynchronous: the flag is
        polled opportunistically and raises at the latest from the
        next run() call."""
        system, state = self._overflowing_state()
        out = system.run(state, n_steps=2, dt_fs=0.1, sync=False)
        jax.block_until_ready(out.positions)
        with pytest.raises(RuntimeError, match="capacity exceeded"):
            system.run(out, n_steps=2, dt_fs=0.1)

    def test_overflowed_is_synchronous(self):
        system, state = self._overflowing_state()
        out = system.run(state, n_steps=2, dt_fs=0.1, sync=False,
                         on_overflow="warn", check_every=10**6)
        assert system.overflowed(out)

    def test_run_warn_on_overflow(self):
        system, state = self._overflowing_state()
        with pytest.warns(UserWarning, match="capacity exceeded"):
            system.run(state, n_steps=2, dt_fs=0.1,
                       on_overflow="warn")

    def test_regrow_consumes_pending_async_flags(self):
        """Flags left queued by a previous async run must route into
        the regrow path (grow + rebuild), not a RuntimeError advising
        the mode the caller is already in."""
        system, state = self._overflowing_state()
        out = system.run(state, n_steps=2, dt_fs=0.1, sync=False,
                         on_overflow="warn", check_every=10**6)
        jax.block_until_ready(out.positions)
        cap0 = system.capacity_2b
        out2 = system.run(out, n_steps=2, dt_fs=0.1,
                          on_overflow="regrow")
        assert system.capacity_2b > cap0
        assert not system.overflowed(out2)

    def test_run_regrows_on_overflow(self):
        """on_overflow='regrow' reverts the busted chunk, grows the
        capacities and completes with full (untruncated) lists."""
        system, state = self._overflowing_state()
        cap0 = system.capacity_2b
        out = system.run(state, n_steps=2, dt_fs=0.1,
                         on_overflow="regrow")
        assert system.capacity_2b > cap0
        assert not system.overflowed(out)
        # the final forces must match a fresh full-capacity oracle
        # evaluation at the final positions (no dropped pairs)
        nbr2, nbr3 = system.build_lists(out.positions, cell=out.cell)
        _, f_ref, _ = system.energy_forces(out.positions, nbr2, nbr3,
                                           cell=out.cell)
        assert np.allclose(np.asarray(out.forces), np.asarray(f_ref),
                           atol=1e-9)


class TestBinaryMD:
    def test_multi_fused_matches_factorized(self):
        """The fused multi-species 2+3-body kernels must agree with
        the factorized oracle exactly (f64)."""
        from uf3_tpu.data.composition import ChemicalSystem
        from uf3_tpu.representation.basis import BSplineBasis
        chem = ChemicalSystem(["Ne", "Xe"], degree=3)
        basis = BSplineBasis(chem, r_min_map=1.0, r_max_map=5.0,
                             resolution_map=8)
        model = ls.WeightedLinearModel(basis)
        rng = np.random.RandomState(11)
        model.coefficients = rng.normal(
            scale=0.05, size=sum(basis.partition_sizes))
        base = bulk("Ne", "fcc", a=5.4) * 3
        numbers = base.get_atomic_numbers()
        numbers[rng.rand(len(numbers)) > 0.5] = 54
        geom = Atoms(numbers=numbers, positions=base.positions,
                     cell=base.cell, pbc=True)
        geom.rattle(0.08, seed=4)
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=5)
        assert system.trio_multi is not None
        assert system.pair_multi is not None
        assert len(system.trio_multi.descs) > 1
        state = system.init_state(temperature=10.0, seed=0)
        # fused multi path (what energy_forces routes to)
        e_m, f_m, _ = system.energy_forces(state.positions,
                                           state.nbr2, state.nbr3)
        # factorized oracle on the same lists
        e_f, f_f, _ = pot.compute_energy_forces(
            system.params, system.species, state.positions,
            system.cell, state.nbr2, state.nbr3, static=system.static)
        assert np.isclose(float(e_m), float(e_f), atol=1e-9)
        assert np.allclose(np.asarray(f_m), np.asarray(f_f),
                           atol=1e-9)
        # fused multi-species analytic virial vs the oracle's
        _, _, v_m = system.energy_forces(state.positions, state.nbr2,
                                         state.nbr3, with_virial=True)
        _, _, v_f = pot.compute_energy_forces(
            system.params, system.species, state.positions,
            system.cell, state.nbr2, state.nbr3, static=system.static)
        assert v_m is not None
        assert np.allclose(np.asarray(v_m), np.asarray(v_f),
                           atol=1e-9)

    def test_binary_md_runs(self, data_dir):
        """Multi-species MD through the fused multi-type kernels."""
        import os
        model = ls.WeightedLinearModel.from_json(
            os.path.join(data_dir, "model_binary.json"))
        rng = np.random.RandomState(3)
        base = bulk("Ne", "fcc", a=5.4) * 3
        numbers = base.get_atomic_numbers()
        numbers[rng.rand(len(numbers)) > 0.5] = 54
        geom = Atoms(numbers=numbers, positions=base.positions,
                     cell=base.cell, pbc=True)
        system = MDSystem(model, geom, dtype=jnp.float64,
                          rebuild_every=5)
        assert system.trio_bundle is None
        state = system.init_state(temperature=50.0, seed=0)
        e0 = float(state.energy) + system.kinetic_energy(state)
        state = system.run(state, n_steps=20, dt_fs=1.0)
        e1 = float(state.energy) + system.kinetic_energy(state)
        assert np.isfinite(e1)
        assert abs(e1 - e0) / len(geom) < 1e-3


class TestMDValidation:
    """Constructor-level input validation (no compiles)."""

    def _model(self):
        return ls.WeightedLinearModel.from_json(
            os.path.join("benchmarks_data", "model_2and3.json"))

    def test_inverted_respa_switch_rejected(self):
        geom = bulk("W", "bcc", a=3.1652) * 3
        with pytest.raises(ValueError, match="r_lo < r_hi"):
            MDSystem(self._model(), geom, n_respa=2,
                     respa_switch=(3.5, 3.5))
        with pytest.raises(ValueError, match="r_lo < r_hi"):
            MDSystem(self._model(), geom, n_respa=2,
                     respa_switch=(3.5, 3.0))

    def test_respa_coarser_than_rebuild_rejected(self):
        geom = bulk("W", "bcc", a=3.1652) * 3
        with pytest.raises(ValueError, match="rebuild_every"):
            MDSystem(self._model(), geom, n_respa=4, rebuild_every=2)

    def test_triangle_capacity_one_falls_back(self):
        """K=1 trio capacity must not crash the (symmetric-grid)
        triangle path: no m < n pairs exist, so forces are pure
        2-body."""
        from uf3_tpu.ops import pallas_trio as pt
        model = self._model()
        geom = bulk("W", "bcc", a=3.1652) * 3
        system = MDSystem(model, geom, dtype=jnp.float64)
        tb = system.trio_bundle
        assert tb.symmetric
        state = system.init_state()
        n3 = state.nbr3
        one = nb.NeighborList(
            idx=n3.idx[:, :1], shift=n3.shift[:, :1],
            mask=n3.mask[:, :1], rev=jnp.zeros_like(n3.rev[:, :1]),
            overflow=n3.overflow,
            reference_positions=n3.reference_positions,
            sel=None if n3.sel is None else n3.sel[:, :1])
        e, f = pt.trio_forces_unrolled(
            tb.grid, state.positions, system.cell, one.idx, one.shift,
            one.mask, one.rev, spec_l=tb.spec_l, spec_n=tb.spec_n,
            l_basis=tb.l_basis, n_basis=tb.n_basis,
            active_bc=tb.active_bc, window=tb.window, triangle=True)
        assert np.all(np.isfinite(np.asarray(f)))
        assert np.allclose(np.asarray(e), 0.0)   # no complete triangle


def test_trajectory_writer(tmp_path):
    """run(callback=TrajectoryWriter(...)) writes parseable extxyz
    frames with energy, step, cell, and forces."""
    from uf3_tpu.data import io
    from uf3_tpu.forcefield.batch import TrajectoryWriter
    model = ls.WeightedLinearModel.from_json(
        os.path.join("benchmarks_data", "model_2and3.json"))
    geom = bulk("W", "bcc", a=3.1652) * 3
    system = MDSystem(model, geom, dtype=jnp.float64, rebuild_every=6)
    state = system.init_state(temperature=300.0, seed=0)
    traj_path = str(tmp_path / "traj.xyz")
    writer = TrajectoryWriter(traj_path, system)
    state = system.run(state, n_steps=18, dt_fs=1.0, callback=writer)
    assert writer.frames_written == 3          # one per chunk
    frames = io.read_xyz(traj_path)
    assert len(frames) == 3
    last = frames[-1]
    assert len(last) == len(geom)
    assert np.allclose(last.get_positions(),
                       np.asarray(state.positions), atol=1e-9)
    assert "fx" in last.arrays
    assert np.isclose(last.info.get("energy", np.nan),
                      float(state.energy), atol=1e-6)
