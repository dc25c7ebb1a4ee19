"""
Minimal, dependency-free atomic-configuration container plus crystal
builders.  Fills the role ase.Atoms plays in the reference package
(uf3 depends on ase throughout); this framework is standalone.

Conventions (matching ase where overlapping):
  * ``cell`` rows are lattice vectors: cartesian = fractional @ cell.
  * ``pbc`` is a length-3 boolean array.
  * ``info`` holds per-configuration scalars (e.g. energy), ``arrays`` holds
    per-atom quantities (e.g. fx, fy, fz).
"""

import re
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from uf3_tpu.data import elements as el

_FORMULA_RE = re.compile(r"([A-Z][a-z]?)(\d*)")


def _parse_formula(formula: str) -> List[int]:
    numbers = []
    for symbol, count in _FORMULA_RE.findall(formula):
        if not symbol:
            continue
        n = int(count) if count else 1
        numbers.extend([el.atomic_numbers[symbol]] * n)
    return numbers


class Atoms:
    """A configuration of atoms: species, positions, cell, and pbc."""

    def __init__(self,
                 symbols: Union[str, Sequence, None] = None,
                 positions: Optional[Sequence] = None,
                 numbers: Optional[Sequence[int]] = None,
                 cell: Optional[Sequence] = None,
                 pbc: Union[bool, Sequence[bool]] = False,
                 info: Optional[Dict] = None,
                 arrays: Optional[Dict] = None):
        if numbers is None:
            if symbols is None:
                numbers = []
            elif isinstance(symbols, str):
                numbers = _parse_formula(symbols)
            else:
                numbers = el.symbols_to_numbers(list(symbols))
        self.numbers = np.asarray(numbers, dtype=np.int64)
        n = len(self.numbers)
        if positions is None:
            positions = np.zeros((n, 3))
        self.positions = np.array(positions, dtype=np.float64).reshape(n, 3)
        if cell is None:
            cell = np.zeros((3, 3))
        cell = np.asarray(cell, dtype=np.float64)
        if cell.shape == (3,):
            cell = np.diag(cell)
        self.cell = cell.reshape(3, 3)
        if isinstance(pbc, (bool, np.bool_)):
            pbc = [pbc] * 3
        self.pbc = np.asarray(pbc, dtype=bool).reshape(3)
        self.info = dict(info) if info else {}
        self.arrays = {k: np.array(v) for k, v in arrays.items()} if arrays \
            else {}
        self.calc = None  # optional attached calculator

    # -- core protocol ------------------------------------------------------
    def __len__(self) -> int:
        return len(self.numbers)

    def __repr__(self) -> str:
        return (f"Atoms({self.get_chemical_formula()}, "
                f"pbc={self.pbc.tolist()})")

    def copy(self) -> "Atoms":
        new = Atoms(numbers=self.numbers.copy(),
                    positions=self.positions.copy(),
                    cell=self.cell.copy(),
                    pbc=self.pbc.copy(),
                    info=dict(self.info))
        new.arrays = {k: v.copy() for k, v in self.arrays.items()}
        return new

    # -- accessors ----------------------------------------------------------
    def get_atomic_numbers(self) -> np.ndarray:
        return self.numbers.copy()

    def get_chemical_symbols(self) -> List[str]:
        return el.numbers_to_symbols(self.numbers)

    def get_chemical_formula(self) -> str:
        syms, counts = np.unique(self.get_chemical_symbols(),
                                 return_counts=True)
        return "".join(f"{s}{c if c > 1 else ''}" for s, c in
                       zip(syms, counts))

    def get_positions(self) -> np.ndarray:
        return self.positions.copy()

    def set_positions(self, positions: Sequence) -> None:
        self.positions = np.array(positions,
                                  dtype=np.float64).reshape(len(self), 3)

    def get_cell(self) -> np.ndarray:
        return self.cell.copy()

    def set_cell(self, cell: Sequence, scale_atoms: bool = False) -> None:
        cell = np.asarray(cell, dtype=np.float64)
        if cell.shape == (3,):
            cell = np.diag(cell)
        if scale_atoms:
            frac = self.get_scaled_positions()
            self.cell = cell.reshape(3, 3)
            self.positions = frac @ self.cell
        else:
            self.cell = cell.reshape(3, 3)

    def get_pbc(self) -> np.ndarray:
        return self.pbc.copy()

    def get_volume(self) -> float:
        vol = np.linalg.det(self.cell)
        if vol == 0:
            raise ValueError("Cell has zero volume.")
        return abs(float(vol))

    def get_masses(self) -> np.ndarray:
        return el.atomic_masses[self.numbers]

    def get_scaled_positions(self, wrap: bool = False) -> np.ndarray:
        frac = np.linalg.solve(self.cell.T, self.positions.T).T
        if wrap:
            frac = frac % 1.0
        return frac

    def set_scaled_positions(self, frac: Sequence) -> None:
        self.positions = np.asarray(frac, dtype=np.float64) @ self.cell

    # -- calculator protocol (ase-compatible subset) ------------------------
    def get_potential_energy(self) -> float:
        if self.calc is None:
            raise RuntimeError("No calculator attached.")
        return self.calc.get_potential_energy(self)

    def get_forces(self) -> np.ndarray:
        if self.calc is None:
            raise RuntimeError("No calculator attached.")
        return self.calc.get_forces(self)

    def get_stress(self) -> np.ndarray:
        if self.calc is None:
            raise RuntimeError("No calculator attached.")
        return self.calc.get_stress(self)

    # -- mutation -----------------------------------------------------------
    def translate(self, displacement: Sequence) -> None:
        self.positions = self.positions + np.asarray(displacement)

    def wrap(self) -> None:
        """Wrap atoms into the unit cell along periodic directions."""
        frac = self.get_scaled_positions()
        for dim in range(3):
            if self.pbc[dim]:
                frac[:, dim] = frac[:, dim] % 1.0
        self.set_scaled_positions(frac)

    def rattle(self, stdev: float = 0.001, seed: int = 42) -> None:
        rng = np.random.RandomState(seed)
        self.positions = self.positions + rng.normal(
            scale=stdev, size=self.positions.shape)

    def repeat(self, reps: Union[int, Sequence[int]]) -> "Atoms":
        """Tile the configuration to build a supercell."""
        if isinstance(reps, (int, np.integer)):
            reps = (reps, reps, reps)
        na, nb, nc = (int(r) for r in reps)
        offsets = np.array([[i, j, k]
                            for i in range(na)
                            for j in range(nb)
                            for k in range(nc)], dtype=np.float64)
        shifts = offsets @ self.cell
        n_img = len(shifts)
        positions = (self.positions[None, :, :]
                     + shifts[:, None, :]).reshape(-1, 3)
        numbers = np.tile(self.numbers, n_img)
        new_cell = self.cell * np.array(reps, dtype=np.float64)[:, None]
        new = Atoms(numbers=numbers, positions=positions, cell=new_cell,
                    pbc=self.pbc.copy(), info=dict(self.info))
        for key, value in self.arrays.items():
            if value.ndim >= 1 and len(value) == len(self):
                new.arrays[key] = np.concatenate([value] * n_img, axis=0)
        return new

    def __mul__(self, reps):
        return self.repeat(reps)

    def new_array(self, name: str, values: Sequence) -> None:
        values = np.asarray(values)
        if name in self.arrays:
            raise RuntimeError(f"Array '{name}' already exists.")
        if len(values) != len(self):
            raise ValueError("Array length does not match number of atoms.")
        self.arrays[name] = values

    def set_array(self, name: str, values: Sequence) -> None:
        self.arrays[name] = np.asarray(values)

    def delete(self, indices: Iterable[int]) -> None:
        """Remove atoms by index (in place)."""
        mask = np.ones(len(self), dtype=bool)
        mask[np.asarray(list(indices), dtype=int)] = False
        self.numbers = self.numbers[mask]
        self.positions = self.positions[mask]
        self.arrays = {k: v[mask] for k, v in self.arrays.items()}


# -- crystal builders -------------------------------------------------------
def bulk(symbol: str,
         structure: str = "bcc",
         a: float = 3.16,
         c: Optional[float] = None,
         cubic: bool = True) -> Atoms:
    """Build a common crystal structure.

    ``cubic=True`` gives the conventional cubic cell for sc/bcc/fcc/
    diamond; ``cubic=False`` gives the primitive cell (1 atom for
    bcc/fcc, 2 for diamond).  ``hcp`` always uses its 2-atom hexagonal
    cell (``c`` defaults to the ideal ratio a*sqrt(8/3)).  Mirrors the
    subset of ase.build.bulk the reference relies on (the reference
    delegates crystal construction to ase throughout).
    """
    z = el.atomic_numbers[symbol]
    if structure == "hcp":
        if c is None:
            c = a * np.sqrt(8.0 / 3.0)
        cell = np.array([[a, 0.0, 0.0],
                         [-0.5 * a, 0.5 * np.sqrt(3.0) * a, 0.0],
                         [0.0, 0.0, c]])
        frac = np.array([[0.0, 0.0, 0.0],
                         [1.0 / 3.0, 2.0 / 3.0, 0.5]])
        positions = frac @ cell
        return Atoms(numbers=[z] * 2, positions=positions, cell=cell,
                     pbc=True)
    if not cubic:
        if structure == "bcc":
            cell = 0.5 * a * np.array([[-1.0, 1.0, 1.0],
                                       [1.0, -1.0, 1.0],
                                       [1.0, 1.0, -1.0]])
            frac = np.array([[0.0, 0.0, 0.0]])
        elif structure == "fcc":
            cell = 0.5 * a * np.array([[0.0, 1.0, 1.0],
                                       [1.0, 0.0, 1.0],
                                       [1.0, 1.0, 0.0]])
            frac = np.array([[0.0, 0.0, 0.0]])
        elif structure == "diamond":
            cell = 0.5 * a * np.array([[0.0, 1.0, 1.0],
                                       [1.0, 0.0, 1.0],
                                       [1.0, 1.0, 0.0]])
            frac = np.array([[0.0, 0.0, 0.0], [0.25, 0.25, 0.25]])
        elif structure == "sc":
            cell = np.eye(3) * a
            frac = np.array([[0.0, 0.0, 0.0]])
        else:
            raise ValueError(f"Unknown structure: {structure}")
        positions = frac @ cell
        return Atoms(numbers=[z] * len(frac), positions=positions,
                     cell=cell, pbc=True)
    cell = np.eye(3) * a
    if structure == "sc":
        frac = np.array([[0.0, 0.0, 0.0]])
    elif structure == "bcc":
        frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    elif structure == "fcc":
        frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                         [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    elif structure == "diamond":
        fcc = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                        [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
        frac = np.concatenate([fcc, fcc + 0.25], axis=0)
    else:
        raise ValueError(f"Unknown structure: {structure}")
    positions = frac @ cell
    return Atoms(numbers=[z] * len(frac), positions=positions, cell=cell,
                 pbc=True)


def rattled_bcc_dataset(n_configs: int, seed: int = 0,
                        symbol: str = "W", a: float = 3.1652):
    """Synthetic fitting set of rattled bcc cells, made from ``seed``.

    Every third configuration is a 4x4x4 cell (128 atoms), the others
    3x3x3 (54 atoms); rattle amplitudes cycle from 0.02 to 0.10 A.
    Energies and forces are Gaussian labels: they size and exercise
    the fit path, they are not physical.  Returns (geometries,
    energies, forces) with forces shaped (3, n_atoms) per config.
    """
    rng = np.random.RandomState(seed)
    geometries, energies, forces = [], [], []
    for i in range(n_configs):
        reps = (3, 3, 3) if i % 3 else (4, 4, 4)
        geom = bulk(symbol, "bcc", a=a) * reps
        geom.rattle(0.02 + 0.08 * (i % 5) / 4, seed=i)
        geometries.append(geom)
        energies.append(float(rng.normal(-11.0, 0.1) * len(geom)))
        forces.append(rng.normal(size=(3, len(geom))) * 0.5)
    return geometries, energies, forces


def molecule_from_arrays(symbols, positions) -> Atoms:
    """Non-periodic configuration from symbol and position arrays."""
    return Atoms(symbols=symbols, positions=positions, pbc=False)
