"""
UFCalculator: energies, forces, and stresses from a fitted model.

Host (numpy, float64) inference engine with the same call semantics as
the reference's ASE calculator (uf3/forcefield/calculator.py:40-487) but
evaluated by contracting coefficients against the fused de Boor kernel
directly -- no per-spline objects and no per-triplet Python loops.  The
jit-compiled device engine (uf3_tpu/forcefield/md.py + uf3_tpu/ops) is the
production path; this calculator is the accuracy oracle and interop shim.
"""

from typing import Dict, List, Tuple

import numpy as np

from uf3_tpu.data import geometry as geo
from uf3_tpu.data.atoms import Atoms
from uf3_tpu.regression.least_squares import WeightedLinearModel
from uf3_tpu.representation import featurize_np as fnp
from uf3_tpu.representation import splines as sp


def coefficients_by_interaction(element_list,
                                interactions_map,
                                partition_sizes,
                                coefficients) -> Dict:
    """Split the flat coefficient vector per interaction."""
    split_indices = np.cumsum(partition_sizes)[:-1]
    pieces = np.array_split(coefficients, split_indices)
    solutions = {el: piece for el, piece
                 in zip(element_list, pieces[:len(element_list)])}
    keys = list(interactions_map[2]) + list(interactions_map.get(3, []))
    for idx, key in enumerate(keys):
        solutions[key] = pieces[len(element_list) + idx]
    return solutions


class UFCalculator:
    """Energy/force/stress evaluation for a fitted UF potential."""

    implemented_properties = ["energy", "forces", "stress"]

    def __init__(self, model: WeightedLinearModel):
        self.model = model
        self.bspline_config = model.bspline_config
        self.solutions = coefficients_by_interaction(
            self.element_list, self.interactions_map,
            self.bspline_config.partition_sizes, model.coefficients)
        # full (decompressed) 3-body coefficient grids per trio
        self.trio_grids = {}
        for trio in self.interactions_map.get(3, []):
            self.trio_grids[trio] = self.bspline_config.decompress_3B(
                self.solutions[trio], trio)

    # -- passthroughs -------------------------------------------------------
    @property
    def degree(self):
        return self.bspline_config.degree

    @property
    def element_list(self):
        return self.bspline_config.element_list

    @property
    def interactions_map(self):
        return self.bspline_config.interactions_map

    @property
    def r_min_map(self):
        return self.bspline_config.r_min_map

    @property
    def r_max_map(self):
        return self.bspline_config.r_max_map

    @property
    def r_cut(self):
        return self.bspline_config.r_cut

    @property
    def coefficients(self):
        return self.model.coefficients

    @property
    def chemical_system(self):
        return self.bspline_config.chemical_system

    @property
    def pair_potentials(self):
        """Pair interaction -> (knots, coefficients) map."""
        return {pair: (self.bspline_config.knots_map[pair],
                       self.solutions[pair])
                for pair in self.interactions_map[2]}

    def __repr__(self):
        return "\n".join(["UFCalculator:", repr(self.model)])

    # -- energies -----------------------------------------------------------
    def get_potential_energy(self, atoms: Atoms,
                             force_consistent: bool = False) -> float:
        supercell = self._supercell(atoms)
        energy = 0.0 if force_consistent else self._energy_1b(atoms)
        energy += self._energy_2b(atoms, supercell)
        if self.degree > 2:
            energy += self._energy_3b(atoms, supercell)
        return energy

    def _supercell(self, atoms: Atoms) -> Atoms:
        if np.any(atoms.get_pbc()):
            return geo.get_supercell(atoms, r_cut=self.r_cut)
        return atoms

    def _energy_1b(self, atoms: Atoms) -> float:
        counts = self.chemical_system.get_composition_tuple(atoms)
        return float(sum(float(np.asarray(self.solutions[el]).flat[0]) * c
                         for el, c in zip(self.element_list, counts)))

    def _energy_2b(self, atoms: Atoms, supercell: Atoms) -> float:
        pair_tuples = self.interactions_map[2]
        distances_map = fnp.distances_by_interaction(
            atoms, pair_tuples, self.r_min_map, self.r_max_map, supercell)
        energy = 0.0
        for pair in pair_tuples:
            r = distances_map[pair]
            if len(r) == 0:
                continue
            knots = self.bspline_config.knots_map[pair]
            energy += float(np.sum(sp.evaluate_spline(
                r, knots, self.solutions[pair])))
        return energy

    def _energy_3b(self, atoms: Atoms, supercell: Atoms) -> float:
        trio_list = self.interactions_map[3]
        knot_sets = [self.bspline_config.knots_map[t] for t in trio_list]
        hashes = self.chemical_system.interaction_hashes[3]
        grids = fnp.energy_grids_3b(atoms, knot_sets, hashes,
                                    supercell=supercell)
        return float(sum(np.sum(grid * self.trio_grids[trio])
                         for grid, trio in zip(grids, trio_list)))

    # -- forces -------------------------------------------------------------
    def get_forces(self, atoms: Atoms) -> np.ndarray:
        supercell = self._supercell(atoms)
        forces = self._forces_2b(atoms, supercell)
        if self.degree > 2:
            forces += self._forces_3b(atoms, supercell)
        return forces

    def _forces_2b(self, atoms: Atoms, supercell: Atoms) -> np.ndarray:
        pair_tuples = self.interactions_map[2]
        dist_map, deriv_map = fnp.derivatives_by_interaction(
            atoms, pair_tuples, self.r_cut, self.r_min_map,
            self.r_max_map, supercell)
        n_atoms = len(atoms)
        forces = np.zeros((n_atoms, 3))
        for pair in pair_tuples:
            r = dist_map[pair]
            if len(r) == 0:
                continue
            i_idx, j_idx, unit = deriv_map[pair]
            knots = self.bspline_config.knots_map[pair]
            dv = sp.evaluate_spline(r, knots, self.solutions[pair], nu=1)
            contrib = dv[:, None] * unit  # (n_pairs, 3)
            j_real = j_idx < n_atoms
            i_real = i_idx < n_atoms
            np.add.at(forces, j_idx[j_real], -contrib[j_real])
            np.add.at(forces, i_idx[i_real], contrib[i_real])
        return forces

    def _forces_3b(self, atoms: Atoms, supercell: Atoms) -> np.ndarray:
        trio_list = self.interactions_map[3]
        knot_sets = [self.bspline_config.knots_map[t] for t in trio_list]
        hashes = self.chemical_system.interaction_hashes[3]
        grids = fnp.force_grids_3b(atoms, knot_sets, hashes,
                                   supercell=supercell)
        forces = np.zeros((len(atoms), 3))
        for grid, trio in zip(grids, trio_list):
            # grid: (n_atoms, 3, L, M, N), already carries the sign
            forces += np.einsum("aclmn,lmn->ac", grid,
                                self.trio_grids[trio])
        return forces

    # -- stress -------------------------------------------------------------
    def get_stress(self, atoms: Atoms, d: float = 1e-6) -> np.ndarray:
        """Numerical stress in Voigt order (xx, yy, zz, yz, xz, xy)."""
        stress = np.zeros((3, 3))
        cell0 = atoms.get_cell()
        volume = atoms.get_volume()
        for i in range(3):
            for j in range(i, 3):
                strain = np.eye(3)
                strain[i, j] += d
                strain[j, i] += d if i != j else 0.0
                probe = atoms.copy()
                probe.set_cell(cell0 @ strain.T, scale_atoms=True)
                e_plus = self.get_potential_energy(probe)
                strain = np.eye(3)
                strain[i, j] -= d
                strain[j, i] -= d if i != j else 0.0
                probe = atoms.copy()
                probe.set_cell(cell0 @ strain.T, scale_atoms=True)
                e_minus = self.get_potential_energy(probe)
                denom = 2 * d * volume * (2 if i != j else 1)
                stress[i, j] = stress[j, i] = (e_plus - e_minus) / denom
        return np.array([stress[0, 0], stress[1, 1], stress[2, 2],
                         stress[1, 2], stress[0, 2], stress[0, 1]])

    # -- relaxation ---------------------------------------------------------
    def relax_fmax(self, geom: Atoms, fmax: float = 0.05,
                   steps: int = 500, dt: float = 0.1,
                   verbose: bool = False) -> Atoms:
        """FIRE minimization of maximum force."""
        from uf3_tpu.forcefield.optimize import fire_minimize
        return fire_minimize(geom, self, fmax=fmax, max_steps=steps,
                             dt_start=dt, verbose=verbose)

    # -- properties ---------------------------------------------------------
    def get_elastic_constants(self, atoms: Atoms, n: int = 5,
                              d: float = 1.0):
        from uf3_tpu.forcefield.properties import elastic
        return elastic.get_elastic_constants(atoms, self, n=n, d=d)

    def get_phonon_data(self, atoms: Atoms, n_super: int = 5,
                        disp: float = 0.05):
        from uf3_tpu.forcefield.properties import phonon
        return phonon.compute_phonon_data(atoms, self, n_super=n_super,
                                          disp=disp)
