"""
Jit-compiled molecular dynamics on the accelerator (JAX/XLA).

One fused step: neighbor reuse (Verlet skin) -> spline energy/forces via
the scatter-free kernels (uf3_tpu/ops/potential.py) -> symplectic
integration, entirely on device with donated state.  Replaces the
reference's per-call supercell + dense-matrix ASE calculator loop
(uf3/forcefield/calculator.py:124-343, which rebuilds everything each
step).  Integrators: NVE velocity Verlet, Langevin NVT (BAOAB), and
Nose-Hoover NVT.
"""

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from uf3_tpu.data import elements
from uf3_tpu.data.atoms import Atoms
from uf3_tpu.forcefield import units
from uf3_tpu.ops import neighbors as nb
from uf3_tpu.ops import potential as pot


class MDState(NamedTuple):
    positions: jnp.ndarray   # (N, 3)
    velocities: jnp.ndarray  # (N, 3) internal units
    forces: jnp.ndarray      # (N, 3) eV / A
    energy: jnp.ndarray      # () potential energy, eV
    nbr2: nb.NeighborList
    nbr3: Optional[nb.NeighborList]
    key: jnp.ndarray         # PRNG key (Langevin)
    xi: jnp.ndarray          # () Nose-Hoover thermostat momentum
    stale: jnp.ndarray       # () bool: skin distance was exceeded
    cell: jnp.ndarray        # (3, 3) simulation cell (traced: NPT scales it)
    f_short: jnp.ndarray = None  # r-RESPA split forces carried across
    f_tail: jnp.ndarray = None   # chunks (valid for the same positions)
    f_mid: jnp.ndarray = None    # 3-level r-RESPA: 3-body force at the
    #   mid timestep (respa_mid > 1), carried like f_short / f_tail


class MDSystem:
    """Binds a fitted potential to a configuration for device MD."""

    def __init__(self,
                 model,
                 atoms: Atoms,
                 dtype=jnp.float32,
                 capacity_2b: int = None,
                 capacity_3b: int = None,
                 skin: float = 0.5,
                 skin_2b: float = None,
                 rebuild_every: int = 20,
                 n_respa: int = 1,
                 respa_mid: int = 1,
                 respa_switch: tuple = None,
                 fused: str = "shared",
                 trio_triangle: bool = False,
                 eager_refilter: bool = True,
                 static_rebuild: bool = False,
                 masses: np.ndarray = None):
        self.params, self.static = pot.build_potential(model, dtype=dtype)
        from uf3_tpu.ops import pallas_trio as pt
        self.trio_bundle = pt.build_trio_bundle(model, dtype=dtype)
        self.pair_fast = pt.build_pair_fast(model, dtype=dtype)
        self.pair_poly = pt.build_pair_poly(model, dtype=dtype)
        # multi-species fused path (loops the pair-lane kernel over
        # trio/pair types with species gates); None if any knot
        # sequence lacks a closed form
        self.trio_multi = None
        self.pair_multi = None
        if self.trio_bundle is None or self.pair_fast is None:
            self.trio_multi = pt.build_trio_multi(model, dtype=dtype)
            self.pair_multi = pt.build_pair_multi(model, dtype=dtype)
        if fused not in ("separate", "shared"):
            raise ValueError("fused must be 'separate' or 'shared'")
        # kernel-route selector: "shared" feeds both kernels from one
        # (N, K2) position gather via the filtered list's parent-slot
        # map; "separate" runs the pair and trio kernels on their own
        # gathers.  Which is faster on the GPU is not measured yet.
        self.fused = fused
        # triangle-lane trio kernel (half the pair-lane work for
        # symmetric unary grids, at the price of irregular index
        # shuffles) -- opt-in
        self.trio_triangle = bool(trio_triangle)
        self.dtype = dtype
        self.skin = float(skin)
        # per-chunk overflow flags not yet resolved on host: polled
        # without blocking so overflow checking never stalls the
        # dispatch pipeline with a host sync per launch
        self._pending_overflow = []
        # two-tier skins: a larger 2-body skin makes the expensive
        # O(N^2)/cell-list rebuild rare, while the (binding) 3-body
        # list is cheaply re-filtered from the still-valid 2-body list
        # whenever half of the smaller 3-body skin is consumed
        self.skin_2b = float(skin_2b) if skin_2b is not None \
            else self.skin
        self.rebuild_every = int(rebuild_every)
        self.degree = model.bspline_config.degree
        self.r_cut_2b = float(self.params.r_cut_2b)
        self.r_cut_3b = float(self.params.r_cut_3b)
        self.two_tier = (self.skin_2b > self.skin
                         and self.degree > 2
                         and self.r_cut_3b <= self.r_cut_2b)
        # unconditional 3B refilter at every chunk boundary (see
        # _rebuild_switch): the staleness-hardened default
        self.eager_refilter = bool(eager_refilter)
        # unconditional FULL rebuild at every chunk boundary instead
        # of the adaptive trigger (a drift reduction feeding a
        # lax.switch): straight-line code, and every cycle starts
        # with exact lists; it pays when a rebuild is cheap next to
        # the switch
        self.static_rebuild = bool(static_rebuild)
        # r-RESPA multiple time stepping: the smooth 2-body tail
        # (r > r_lo, split by a C^2 quintic switch) integrates on the
        # outer step dt * n_respa; the stiff short-range 2-body +
        # 3-body forces -- evaluated on the compact 3-body list with
        # one (N, K3) gather -- take the inner step.  Valid split
        # requires r_hi <= r_cut_3b so the short range is covered by
        # the 3-body list (same Verlet-skin argument as the trio legs).
        self.n_respa = int(n_respa)
        if self.n_respa > 1:
            if not (self.degree > 2 and self.r_cut_3b
                    <= self.r_cut_2b):
                raise ValueError("n_respa > 1 requires a 2+3-body "
                                 "model with r_cut_3b <= r_cut_2b")
            if respa_switch is None:
                r_hi = float(self.r_cut_3b)
                respa_switch = (r_hi - 0.5, r_hi)
            if respa_switch[1] > self.r_cut_3b + 1e-9:
                raise ValueError("respa_switch upper radius must not "
                                 "exceed r_cut_3b")
            if not respa_switch[0] < respa_switch[1]:
                raise ValueError("respa_switch must satisfy "
                                 "r_lo < r_hi (got "
                                 f"{respa_switch})")
            if self.n_respa > rebuild_every:
                raise ValueError(
                    "n_respa must not exceed rebuild_every: each jit "
                    "chunk integrates whole outer cycles, so the "
                    "neighbor-rebuild cadence cannot be finer than "
                    "one outer step "
                    f"(n_respa={self.n_respa}, "
                    f"rebuild_every={rebuild_every})")
        # 3-level r-RESPA: with respa_mid > 1 the 3-body force (the
        # expensive map + cross-atom assembly) moves to its own mid
        # timestep dt * respa_mid; the innermost step integrates ONLY
        # the switched short-range pair force, which is row-local on
        # the (N, K3) rows -- no assembly gather.  The three forces
        # partition the total exactly (S + (1 - S) = 1 on pairs, the
        # 3-body term whole at the mid level).
        self.respa_mid = int(respa_mid)
        if self.respa_mid > 1:
            if self.n_respa <= 1:
                raise ValueError("respa_mid > 1 requires n_respa > 1")
            if self.n_respa % self.respa_mid != 0:
                raise ValueError(
                    "n_respa must be a multiple of respa_mid "
                    f"(got n_respa={self.n_respa}, "
                    f"respa_mid={self.respa_mid})")
        self.respa_switch = respa_switch
        # coefficient-selection window for the switched short-range
        # pair force: S(r) V(r) vanishes for r >= r_hi, so the select
        # chain stops at interval(r_hi) + 4 basis functions (13 of 18
        # at the bench model) -- exact, see pallas_trio.basis_window_hi
        self.n_basis_short = None
        if self.n_respa > 1 and self.pair_fast is not None:
            from uf3_tpu.ops import pallas_trio as pt
            self.n_basis_short = pt.basis_window_hi(
                self.pair_fast[0], respa_switch[1])
        numbers = atoms.get_atomic_numbers()
        self.atomic_numbers = np.asarray(numbers)
        self.species = jnp.asarray(
            np.asarray(self.params.z_to_species)[numbers])
        # per-atom mass override (e.g. effectively-infinite masses pin
        # a group in place -- the two-phase melting protocol's frozen
        # half, LAMMPS `fix npt right` leaving `left` unintegrated in
        # /root/reference/supplement/melting_point/melting_uf.in)
        self.masses = jnp.asarray(
            elements.atomic_masses[numbers] if masses is None
            else masses, dtype=dtype)
        # thermostats and the temperature observable count only MOBILE
        # degrees of freedom: effectively-infinite masses (the pinning
        # convention above) carry ~zero kinetic energy, and counting
        # them would drive Nose-Hoover toward ~2x the target when half
        # the box is pinned (and misreport T the same way)
        _m_host = np.asarray(elements.atomic_masses[numbers]
                             if masses is None else masses)
        self.n_mobile = int(np.sum(_m_host < 1e9))
        self.dof = max(1, 3 * self.n_mobile
                       - (3 if self.n_mobile == len(atoms) else 0))
        # kinetic-energy mask: a Langevin thermostat equipartitions
        # kT/2 into EVERY dof regardless of mass, so pinned
        # (effectively-infinite-mass) atoms carry full kinetic energy
        # at ~zero velocity; the temperature observable and the
        # barostat's kinetic pressure must count mobile atoms only
        self.mobile_mask = (None if self.n_mobile == len(atoms)
                            else jnp.asarray(_m_host < 1e9))
        self.cell = jnp.asarray(atoms.get_cell(), dtype=dtype)
        self.pbc = tuple(bool(p) for p in atoms.get_pbc())
        self.volume = atoms.get_volume() if np.any(atoms.get_pbc()) else None
        n_atoms = len(atoms)
        volume = self.volume or 1e6
        self.capacity_2b = capacity_2b or nb.estimate_capacity(
            n_atoms, volume, self.r_cut_2b + self.skin_2b)
        if self.degree > 2:
            self.capacity_3b = capacity_3b or nb.estimate_capacity(
                n_atoms, volume, self.r_cut_3b + self.skin)
        else:
            self.capacity_3b = 0
        self._positions0 = jnp.asarray(atoms.get_positions(), dtype=dtype)
        # small periodic cells (width < 2 * cutoff): the minimum-image
        # builder would silently drop pairs, so scan explicit images
        if np.any(atoms.get_pbc()):
            req = nb.images_required(atoms.get_cell(), self.pbc,
                                     self.r_cut_2b + self.skin_2b)
            self._images_2b = None if max(req) == 0 else tuple(
                max(1, r) if p else 0 for r, p in zip(req, self.pbc))
        else:
            self._images_2b = None
        # cell-list geometry (static): used when the box is large
        # enough that O(N) binning beats the O(N^2) scan
        self._cells_2b = self._cell_list_setup(atoms,
                                               self.r_cut_2b
                                               + self.skin_2b)
        self._cells_3b = self._cell_list_setup(atoms,
                                               self.r_cut_3b + self.skin) \
            if self.degree > 2 else None

    def _cell_list_setup(self, atoms, r_cut):
        if not np.any(atoms.get_pbc()) or len(atoms) < 512:
            return None
        grid_shape = nb.grid_shape_for(atoms.get_cell(), r_cut,
                                       atoms.get_pbc())
        n_bins = int(np.prod(grid_shape))
        if n_bins < 16:
            return None
        # size bins from the MEASURED initial occupancy, not the mean:
        # lattice planes aligning with bin boundaries concentrate up to
        # ~1.8x the mean in one bin, and over-full bins silently drop
        # atoms (flagged by NeighborList.overflow but still wrong)
        frac = atoms.get_positions() @ np.linalg.inv(atoms.get_cell())
        frac = frac - np.floor(frac)
        coord = np.clip((frac * grid_shape).astype(int), 0,
                        np.asarray(grid_shape) - 1)
        bin_id = ((coord[:, 0] * grid_shape[1] + coord[:, 1])
                  * grid_shape[2] + coord[:, 2])
        occ = np.bincount(bin_id, minlength=n_bins).max()
        bin_capacity = max(8, int(np.ceil(occ * 1.3)) + 2)
        topology = nb.bin_topology(grid_shape, atoms.get_pbc())
        return (grid_shape, bin_capacity, topology)

    # -- neighbor construction ---------------------------------------------
    def _build_one(self, positions, cell, r_cut, capacity, cells,
                   with_rev=False, wrapped=False):
        # the reverse-slot map is only needed by the 3-body kernel;
        # skipping it for the (much wider) 2-body list saves an
        # (N, K2, K2) pass per rebuild
        if cells is not None:
            grid_shape, bin_capacity, topology = cells
            return nb.build_neighbor_list_cells(
                positions, cell, self.pbc, r_cut, capacity,
                grid_shape, bin_capacity, topology, with_rev=with_rev,
                assume_wrapped=wrapped)
        if self._images_2b is not None:
            return nb.build_neighbor_list_images(
                positions, cell, self.pbc, r_cut, capacity,
                images=self._images_2b, with_rev=with_rev)
        return nb.build_neighbor_list(positions, cell, self.pbc, r_cut,
                                      capacity, with_rev=with_rev)

    def build_lists(self, positions, cell=None, wrapped=False):
        cell = self.cell if cell is None else cell
        nbr2 = self._build_one(positions, cell,
                               self.r_cut_2b + self.skin_2b,
                               self.capacity_2b, self._cells_2b,
                               wrapped=wrapped)
        nbr3 = None
        if self.degree > 2:
            if self.r_cut_3b <= self.r_cut_2b:
                # the 3-body list is a subset of the 2-body list
                nbr3 = nb.filter_neighbor_list(
                    nbr2, positions, cell, self.r_cut_3b + self.skin,
                    self.capacity_3b)
            else:
                nbr3 = self._build_one(positions, cell,
                                       self.r_cut_3b + self.skin,
                                       self.capacity_3b, self._cells_3b,
                                       wrapped=wrapped)
        return nbr2, nbr3

    def _wrap(self, positions, cell):
        """Wrap into the primary cell (exact lattice translation); the
        cell-list builder then skips per-pair base-image bookkeeping."""
        if not any(self.pbc):
            return positions
        return nb.wrap_positions(positions, cell, self.pbc)

    @staticmethod
    def _voigt6_to_matrix(v6):
        """Symmetric (3, 3) virial from the Voigt 6-vector
        (xx, yy, zz, yz, xz, xy)."""
        return jnp.stack([
            jnp.stack([v6[0], v6[5], v6[4]]),
            jnp.stack([v6[5], v6[1], v6[3]]),
            jnp.stack([v6[4], v6[3], v6[2]])])

    def energy_forces(self, positions, nbr2, nbr3, cell=None,
                      with_energy=True, with_virial=False,
                      cache2=None, cache3=None):
        """Energy + forces (+ analytic virial) via the fused kernels.
        with_energy=False elides the 3-body energy accumulation
        (forces-only MD inner steps); with_virial=True emits the
        analytic (3, 3) virial from the same fused pass (None
        otherwise).  cache2/cache3 carry per-chunk loop invariants
        (masks, shift products, transposed index columns) hoisted out
        of the scan."""
        cell = self.cell if cell is None else cell
        if (self.trio_multi is not None and self.pair_multi is not None
                and nbr3 is not None):
            from uf3_tpu.ops import pallas_trio as pt
            e1 = jnp.sum(self.params.offsets_1b[self.species])
            specs, coeffs, ptable, _ = self.pair_multi
            if cache2 is None:
                cache2 = pt.build_pair_cache(
                    nbr2.idx, nbr2.shift, nbr2.mask, cell, self.dtype,
                    species=self.species, pair_type=ptable)
            if cache3 is None:
                cache3 = pt.build_trio_cache(nbr3, cell, self.dtype,
                                             species=self.species)
            out2 = pt.pair_forces_multi(
                coeffs, positions, cell, nbr2.idx, nbr2.shift,
                nbr2.mask, specs=specs, with_energy=with_energy,
                with_virial=with_virial, cache=cache2)
            out3 = pt.trio_forces_multi(
                self.trio_multi.grids, self.species, positions, cell,
                nbr3.idx, nbr3.shift, nbr3.mask, nbr3.rev,
                descs=self.trio_multi.descs,
                with_energy=with_energy, with_virial=with_virial,
                cache=cache3)
            e2, f2 = out2[0], out2[1]
            e3, f3 = out3[0], out3[1]
            virial = self._voigt6_to_matrix(out2[2] + out3[2]) \
                if with_virial else None
            return (e1 + e2 + jnp.sum(e3), f2 + f3, virial)
        if (self.trio_bundle is not None and self.pair_fast is not None
                and nbr3 is not None and nbr3.sel is not None
                and self.fused == "shared"):
            # shared-gather fast path: one (N, K2) position gather
            # feeds both kernels; trio displacements selected from the
            # pair rows via the filtered list's parent-slot map
            from uf3_tpu.ops import pallas_trio as pt
            e1 = jnp.sum(self.params.offsets_1b[self.species])
            pair_spec, pair_coeff = self.pair_fast
            tb = self.trio_bundle
            e2, e3, forces, v6 = pt.pair_trio_forces_shared(
                pair_coeff, tb.grid, positions, cell, nbr2, nbr3,
                spec_pair=pair_spec, n_basis_pair=pair_spec.n_basis,
                spec_l=tb.spec_l, spec_n=tb.spec_n,
                l_basis=tb.l_basis, n_basis=tb.n_basis,
                with_energy=with_energy, with_virial=with_virial,
                active_bc=tb.active_bc, window=tb.window,
                triangle=tb.symmetric and self.trio_triangle,
                cache2=cache2, cache3=cache3)
            virial = self._voigt6_to_matrix(v6) if with_virial \
                else None
            return (e1 + e2 + jnp.sum(e3), forces, virial)
        if self.trio_bundle is not None and nbr3 is not None:
            from uf3_tpu.ops import pallas_trio as pt
            e1 = jnp.sum(self.params.offsets_1b[self.species])
            v2 = None
            if self.pair_fast is not None:
                pair_spec, pair_coeff = self.pair_fast
                out2 = pt.pair_forces_unrolled(
                    pair_coeff, positions, cell, nbr2.idx, nbr2.shift,
                    nbr2.mask, spec=pair_spec,
                    n_basis=pair_spec.n_basis,
                    with_energy=with_energy,
                    with_virial=with_virial, cache=cache2)
                e2, f2 = out2[0], out2[1]
                if with_virial:
                    v2 = out2[2]
            else:
                e2, f2, v2_mat = pot.pair_contributions_fast(
                    self.params, self.static, self.species, positions,
                    cell, nbr2)
                e2 = jnp.sum(e2)
                if with_virial:
                    v2 = jnp.stack([v2_mat[a, b]
                                    for a, b in pt.VOIGT_AB])
            out3 = pt.trio_forces_unrolled(
                self.trio_bundle.grid, positions, cell, nbr3.idx,
                nbr3.shift, nbr3.mask, nbr3.rev,
                spec_l=self.trio_bundle.spec_l,
                spec_n=self.trio_bundle.spec_n,
                l_basis=self.trio_bundle.l_basis,
                n_basis=self.trio_bundle.n_basis,
                with_energy=with_energy, with_virial=with_virial,
                active_bc=self.trio_bundle.active_bc,
                window=self.trio_bundle.window,
                triangle=(self.trio_bundle.symmetric
                          and self.trio_triangle), cache=cache3)
            e3, f3 = out3[0], out3[1]
            virial = self._voigt6_to_matrix(v2 + out3[2]) \
                if with_virial else None
            return (e1 + jnp.sum(e2) + jnp.sum(e3), f2 + f3, virial)
        return pot.compute_energy_forces(self.params, self.species,
                                         positions, cell, nbr2,
                                         nbr3, static=self.static)

    def energy_forces_virial(self, positions, nbr2, nbr3, cell=None):
        cell = self.cell if cell is None else cell
        return pot.compute_energy_forces(self.params, self.species,
                                         positions, cell, nbr2,
                                         nbr3, static=self.static)

    # -- state setup --------------------------------------------------------
    def init_state(self,
                   velocities: np.ndarray = None,
                   temperature: float = None,
                   seed: int = 0,
                   rng_impl: str = "rbg") -> MDState:
        positions = self._wrap(self._positions0, self.cell)
        n_atoms = positions.shape[0]
        # rbg: XLA's RngBitGenerator, statistically ample for
        # thermostat noise; pass rng_impl="threefry2x32" for the jax
        # default
        key = jax.random.key(seed, impl=rng_impl)
        if velocities is None:
            if temperature is None:
                velocities = jnp.zeros_like(positions)
            else:
                key, sub = jax.random.split(key)
                sigma = jnp.sqrt(units.kB * temperature
                                 / self.masses)[:, None]
                velocities = sigma * jax.random.normal(
                    sub, positions.shape, dtype=self.dtype)
                velocities = velocities - jnp.mean(velocities, axis=0)
        else:
            velocities = jnp.asarray(velocities, dtype=self.dtype)
        nbr2, nbr3 = self.build_lists(positions, wrapped=True)
        overflow = nbr2.overflow if nbr3 is None \
            else nbr2.overflow | nbr3.overflow
        if bool(overflow):
            raise ValueError(
                "neighbor capacity exceeded at initialization "
                f"(capacity_2b={self.capacity_2b}, "
                f"capacity_3b={self.capacity_3b}); increase capacities")
        energy, forces, _ = self.energy_forces(positions, nbr2, nbr3)
        return MDState(positions=positions, velocities=velocities,
                       forces=forces, energy=energy, nbr2=nbr2, nbr3=nbr3,
                       key=key, xi=jnp.zeros((), dtype=self.dtype),
                       stale=jnp.zeros((), dtype=bool),
                       cell=self.cell)

    # -- integrators --------------------------------------------------------
    def _verlet_step(self, state: MDState, dt, thermostat=None,
                     temperature=None, tau=None, friction=None,
                     with_energy=True, cache2=None, cache3=None,
                     barostat=None, pressure=0.0, tau_p=None,
                     beta_t=None, scale=None):
        """One velocity-Verlet step; optional Langevin / Nose-Hoover
        thermostat and (barostat='scr') per-step stochastic cell
        rescaling [Bernetti & Bussi, J. Chem. Phys. 153, 114107
        (2020)]: d(ln V) = -beta_T/tau_p (P0 - P_int) dt
        + sqrt(2 kB T beta_T / (V tau_p)) dW, which samples the true
        NPT ensemble (the reference's melting protocol is LAMMPS NPT,
        supplement/melting_point/melting_uf.in).  ``scale`` carries
        the cumulative isotropic cell factor relative to the chunk's
        cache cell; returns (state, new_scale)."""
        m = self.masses[:, None]
        cell = state.cell
        c2, c3 = cache2, cache3
        if barostat == "scr" and scale is not None:
            # isotropic scaling: the cached shift @ cell products are
            # linear in the cell, so rescale instead of rebuilding
            cell = cell * scale
            if c2 is not None:
                c2 = c2._replace(sd=c2.sd * scale)
            if c3 is not None:
                c3 = c3._replace(sd=c3.sd * scale)
        v = state.velocities + 0.5 * dt * state.forces / m
        x = state.positions + dt * v
        with_virial = barostat == "scr"
        energy, forces, virial = self.energy_forces(
            x, state.nbr2, state.nbr3, cell=cell,
            with_energy=with_energy, with_virial=with_virial,
            cache2=c2, cache3=c3)
        v = v + 0.5 * dt * forces / m
        dof = self.dof
        v, key, xi = self._thermostat_update(
            v, state.key, state.xi, dt, thermostat, temperature,
            friction, tau, m, dof)
        if barostat == "scr":
            vv = v if self.mobile_mask is None \
                else v * self.mobile_mask[:, None]
            ke = 0.5 * jnp.sum(m * vv * vv)
            volume = jnp.abs(jnp.linalg.det(cell))
            p_int = (2.0 * ke - (virial[0, 0] + virial[1, 1]
                                 + virial[2, 2])) / (3.0 * volume)
            key, sub = jax.random.split(key)
            noise = jax.random.normal(sub, (), dtype=x.dtype)
            d_eps = (-(beta_t / tau_p) * (pressure - p_int) * dt
                     + jnp.sqrt(2.0 * units.kB * temperature * beta_t
                                * dt / (volume * tau_p)) * noise)
            lam = jnp.exp(d_eps / 3.0)
            x = x * lam
            v = v / lam
            scale = scale * lam
        stale = state.stale | nb.needs_rebuild(state.nbr2, x,
                                               self.skin_2b)
        if self.two_tier:
            stale = stale | nb.needs_rebuild(state.nbr3, x, self.skin)
        out = MDState(positions=x, velocities=v, forces=forces,
                      energy=energy, nbr2=state.nbr2, nbr3=state.nbr3,
                      key=key, xi=xi, stale=stale, cell=state.cell)
        if barostat == "scr":
            return out, scale
        return out

    # note: state buffers alias (neighbor reference positions share the
    # positions buffer at init), so whole-state donation is not valid;
    # the state is rebuilt functionally each call.
    def _rebuild_switch(self, state: MDState):
        """Adaptive neighbor refresh at a chunk boundary: refresh the
        lists only when atoms have used up half of the skin margin
        (the other half covers this chunk's drift).  ONE lax.switch
        over (positions, lists): the full-rebuild / 3B-refilter /
        no-op choice is merged into a single conditional.  Returns
        (positions, nbr2, nbr3)."""
        cell_c = state.cell

        def _keep(x, n2, n3):
            return x, n2, n3

        def _refilter(x, n2, n3):
            # the 3-body skin is the tight one: re-filter its list
            # from the (still valid) 2-body candidates -- O(N*K2)
            n3b = nb.filter_neighbor_list(
                n2, x, cell_c, self.r_cut_3b + self.skin,
                self.capacity_3b, reference_positions=x)
            return x, n2, n3b

        def _full(x, n2, n3):
            x_w = self._wrap(x, cell_c)
            nn2, nn3 = self.build_lists(x_w, cell_c, wrapped=True)
            return x_w, nn2, nn3

        if self.static_rebuild:
            # unconditional full rebuild: no trigger reduction, no
            # switch -- straight-line code XLA can pipeline
            return _full(state.positions, state.nbr2, state.nbr3)
        trigger2 = nb.needs_rebuild(state.nbr2, state.positions,
                                    0.5 * self.skin_2b)
        if self.two_tier and self.eager_refilter:
            # UNCONDITIONAL 3-body refilter every chunk boundary: the
            # refilter is an O(N*K2) pass, and resetting the 3B
            # staleness reference each cycle makes a stale launch
            # require > skin/2 of drift within ONE rebuild_every
            # window -- ~4x the 3-sigma ballistic bound at the bench
            # cadence, vs the thin margin of the trigger scheme below
            # (benchmarks/probe_stale.py).  Also collapses the 3-way
            # lax.switch to 2-way.
            branch = jnp.where(trigger2, 1, 0)
            branches = [_refilter, _full]
        elif self.two_tier:
            # legacy margin scheme: refresh the 3-body refilter at
            # 0.4x skin (staleness trips at 0.5x; the 0.1x-skin gap
            # covers one cycle's tail drift most of the time but is
            # crossable -- see benchmarks/probe_stale.py)
            trigger3 = nb.needs_rebuild(state.nbr3, state.positions,
                                        0.4 * self.skin)
            branch = jnp.where(trigger2, 2,
                               jnp.where(trigger3, 1, 0))
            branches = [_keep, _refilter, _full]
        else:
            branch = jnp.where(trigger2, 1, 0)
            branches = [_keep, _full]
        return jax.lax.switch(branch, branches, state.positions,
                              state.nbr2, state.nbr3)

    @functools.partial(jax.jit, static_argnums=(0,),
                       static_argnames=("n_steps", "dt_fs", "thermostat",
                                        "barostat", "n_chunks"))
    def _run_chunk(self, state: MDState, n_steps: int, dt_fs: float,
                   thermostat: Optional[str] = None,
                   temperature: float = 300.0,
                   tau_fs: float = 100.0,
                   friction_ps: float = 2.0,
                   barostat: Optional[str] = None,
                   pressure: float = 0.0,
                   tau_p_fs: float = 1000.0,
                   compressibility: float = 5e-3,
                   n_chunks: int = 1) -> MDState:
        """One jit launch: ``n_chunks`` rebuild cycles, each = neighbor
        rebuild + n_steps of MD.  ``n_chunks > 1`` scans whole cycles
        inside the launch (same dispatch-amortization rationale as
        _run_chunk_respa) -- the path NPT melting runs on, so pressure
        coupling is not capped by one host round-trip per rebuild.
        Overflow flags from in-launch rebuilds are OR-accumulated onto
        the returned lists; staleness is sticky across cycles within
        the launch."""
        dt = jnp.asarray(dt_fs * units.fs, dtype=self.dtype)
        tau = tau_fs * units.fs
        friction = friction_ps / units.ps
        tau_p = tau_p_fs * units.fs
        baro_kw = dict(barostat=barostat, pressure=pressure,
                       tau_p=tau_p, beta_t=compressibility) \
            if barostat == "scr" else {}

        def one_cycle(state: MDState, compute_energy: bool) -> MDState:
            x, nbr2, nbr3 = self._rebuild_switch(state)
            # accumulate overflow across in-launch rebuilds (a fresh
            # build would otherwise overwrite an earlier cycle's flag)
            nbr2 = nbr2._replace(
                overflow=nbr2.overflow | state.nbr2.overflow)
            if nbr3 is not None:
                nbr3 = nbr3._replace(
                    overflow=nbr3.overflow | state.nbr3.overflow)
            state = state._replace(positions=x, nbr2=nbr2, nbr3=nbr3)
            # the neighbor lists and cell are invariant for the rest
            # of the cycle: close over them instead of threading them
            # through the inner scan carry (XLA may copy carried
            # buffers every iteration)
            cell = state.cell
            energy0 = state.energy
            # hoist per-cycle loop invariants (masks, shift products,
            # transposed index columns) out of the scan: XLA does not
            # do this itself when the lists are cond outputs, and
            # would recompute them every step
            cache2 = cache3 = None
            if self.trio_bundle is not None \
                    and self.pair_fast is not None and nbr3 is not None:
                from uf3_tpu.ops import pallas_trio as pt
                cache2 = pt.build_pair_cache(nbr2.idx, nbr2.shift,
                                             nbr2.mask, cell,
                                             self.dtype)
                cache3 = pt.build_trio_cache(nbr3, cell, self.dtype)
            elif (self.trio_multi is not None
                  and self.pair_multi is not None and nbr3 is not None):
                from uf3_tpu.ops import pallas_trio as pt
                cache2 = pt.build_pair_cache(
                    nbr2.idx, nbr2.shift, nbr2.mask, cell, self.dtype,
                    species=self.species,
                    pair_type=self.pair_multi[2])
                cache3 = pt.build_trio_cache(nbr3, cell, self.dtype,
                                             species=self.species)

            def fast_step(carry, _):
                x, v, f, key, xi, stale_c, scale_c = carry
                s = MDState(positions=x, velocities=v, forces=f,
                            energy=energy0, nbr2=nbr2, nbr3=nbr3,
                            key=key, xi=xi, stale=stale_c, cell=cell)
                out = self._verlet_step(
                    s, dt, thermostat=thermostat,
                    temperature=temperature, tau=tau,
                    friction=friction, with_energy=False,
                    cache2=cache2, cache3=cache3, scale=scale_c,
                    **baro_kw)
                s, scale_c = out if barostat == "scr" \
                    else (out, scale_c)
                return (s.positions, s.velocities, s.forces, s.key,
                        s.xi, s.stale, scale_c), None

            # forces-only inner steps; the cycle's last step also
            # computes the potential energy when requested
            scale = jnp.ones((), dtype=self.dtype)
            if n_steps > 1:
                carry = (state.positions, state.velocities,
                         state.forces, state.key, state.xi,
                         state.stale, scale)
                carry, _ = jax.lax.scan(fast_step, carry, None,
                                        length=n_steps - 1)
                x, v, f, key, xi, stale_c, scale = carry
                state = MDState(positions=x, velocities=v, forces=f,
                                energy=energy0, nbr2=nbr2, nbr3=nbr3,
                                key=key, xi=xi, stale=stale_c,
                                cell=cell)
            out = self._verlet_step(
                state, dt, thermostat=thermostat,
                temperature=temperature, tau=tau, friction=friction,
                with_energy=compute_energy, cache2=cache2,
                cache3=cache3, scale=scale, **baro_kw)
            if barostat == "scr":
                state, scale = out
                state = state._replace(cell=state.cell * scale)
            else:
                state = out
            if not compute_energy:
                state = state._replace(energy=energy0)
            return state

        # the flag resets per LAUNCH (run() ORs it into any_stale);
        # within the launch the cycles keep it sticky
        state = state._replace(stale=jnp.zeros((), dtype=bool))
        if n_chunks > 1:
            def body(c, _):
                return one_cycle(c, False), None
            state, _ = jax.lax.scan(body, state, None,
                                    length=n_chunks - 1)
        return one_cycle(state, True)

    @functools.partial(jax.jit, static_argnums=(0,),
                       static_argnames=("n_outer", "dt_fs",
                                        "thermostat",
                                        "compute_energy", "n_chunks"))
    def _run_chunk_respa(self, state: MDState, n_outer: int,
                         dt_fs: float,
                         thermostat: Optional[str] = None,
                         temperature: float = 300.0,
                         tau_fs: float = 100.0,
                         friction_ps: float = 2.0,
                         compute_energy: bool = True,
                         n_chunks: int = 1) -> MDState:
        """One jit launch of r-RESPA MD: ``n_chunks`` rebuild cycles,
        each = neighbor rebuild + n_outer outer cycles of [tail
        half-kick, n_respa inner velocity-Verlet steps on the
        short-range force, tail half-kick].  Inner steps gather only
        the (N, K3) trio rows; the (N, K2) pair gather runs once per
        outer cycle.

        ``n_chunks > 1`` scans the whole rebuild cycle inside the
        launch: dispatching one chunk per launch costs a host dispatch
        per rebuild_every steps, while the in-launch scan carries the
        (fixed-shape) neighbor lists once per cycle instead.  Overflow
        flags from every in-launch rebuild are OR-accumulated onto the
        returned lists so asynchronous polling still sees them."""
        if (state.f_short is None or state.f_tail is None
                or (self.respa_mid > 1 and state.f_mid is None)):
            # split forces are position-functions only and the entry
            # lists are complete within their cutoffs (skin
            # invariant), so computing them from the entry lists is
            # exact; chunk boundaries afterwards carry them.  A state
            # carried over from a 2-level system (f_short/f_tail set,
            # f_mid absent) must ALSO recompute: its f_short has
            # different semantics (pair+trio) than the 3-level
            # pair-only split
            if self.respa_mid > 1:
                f_ps, f_mid, f_tail = self._respa_split_forces_3l(
                    state)
                state = state._replace(f_short=f_ps, f_mid=f_mid,
                                       f_tail=f_tail)
            else:
                f_short, f_tail = self._respa_split_forces(state)
                state = state._replace(f_short=f_short, f_tail=f_tail)

        # the flag resets per LAUNCH (run() ORs it into any_stale);
        # within the launch the cycles keep it sticky
        state = state._replace(stale=jnp.zeros((), dtype=bool))

        def cycle(s, ce):
            if self.respa_mid > 1:
                return self._respa_cycle_3l(
                    s, n_outer, dt_fs, thermostat, temperature,
                    tau_fs, friction_ps, ce)
            return self._respa_cycle(
                s, n_outer, dt_fs, thermostat, temperature, tau_fs,
                friction_ps, ce)

        if n_chunks > 1:
            def body(c, _):
                return cycle(c, False), None
            state, _ = jax.lax.scan(body, state, None,
                                    length=n_chunks - 1)
        return cycle(state, compute_energy)

    def _thermostat_update(self, v, key, xi, dt, thermostat,
                           temperature, friction, tau, m, dof):
        """One thermostat application (shared by the plain Verlet and
        both r-RESPA cycle integrators): Langevin c1/cn kick or
        Nose-Hoover xi integration; no-op otherwise."""
        if thermostat == "langevin":
            key, sub = jax.random.split(key)
            c1 = jnp.exp(-friction * dt)
            cn = jnp.sqrt((1 - c1 ** 2) * units.kB * temperature / m)
            v = c1 * v + cn * jax.random.normal(sub, v.shape,
                                                dtype=v.dtype)
        elif thermostat == "nose_hoover":
            ke = 0.5 * jnp.sum(m * v * v)
            q = dof * units.kB * temperature * tau ** 2
            xi = xi + dt * (2.0 * ke
                            - dof * units.kB * temperature) / q
            v = v * jnp.exp(-xi * dt)
        return v, key, xi

    def _respa_split_forces(self, state: MDState):
        """(f_short, f_tail) at ``state``'s positions from its lists."""
        from uf3_tpu.ops import pallas_trio as pt
        spec_pair, pair_coeff = self.pair_fast
        tb = self.trio_bundle
        r_lo, r_hi = self.respa_switch
        _, _, f_short = pt.trio_short_forces(
            pair_coeff, tb.grid, state.positions, state.cell,
            state.nbr3, spec_pair=spec_pair,
            n_basis_pair=self.n_basis_short, spec_l=tb.spec_l,
            spec_n=tb.spec_n, l_basis=tb.l_basis,
            n_basis=tb.n_basis, active_bc=tb.active_bc,
            window=tb.window, r_lo=r_lo, r_hi=r_hi,
            triangle=tb.symmetric and self.trio_triangle)
        _, f_tail = pt.pair_tail_forces(
            pair_coeff, state.positions, state.cell, state.nbr2,
            spec_pair=spec_pair, n_basis_pair=spec_pair.n_basis,
            r_lo=r_lo, r_hi=r_hi)
        return f_short, f_tail

    def _respa_cycle(self, state: MDState, n_outer: int,
                     dt_fs: float,
                     thermostat: Optional[str],
                     temperature: float,
                     tau_fs: float,
                     friction_ps: float,
                     compute_energy: bool) -> MDState:
        """One traced rebuild cycle of r-RESPA MD (see
        _run_chunk_respa); requires state.f_short / state.f_tail."""
        from uf3_tpu.ops import pallas_trio as pt
        dt = jnp.asarray(dt_fs * units.fs, dtype=self.dtype)
        friction = friction_ps / units.ps
        tau = tau_fs * units.fs
        n_r = self.n_respa
        dt_out = dt * n_r
        x, nbr2, nbr3 = self._rebuild_switch(state)
        # accumulate overflow across in-launch rebuilds (a fresh build
        # would otherwise overwrite an earlier cycle's flag)
        nbr2 = nbr2._replace(
            overflow=nbr2.overflow | state.nbr2.overflow)
        nbr3 = nbr3._replace(
            overflow=nbr3.overflow | state.nbr3.overflow)
        cell = state.cell
        cache2 = pt.build_pair_cache(nbr2.idx, nbr2.shift, nbr2.mask,
                                     cell, self.dtype)
        cache3 = pt.build_trio_cache(nbr3, cell, self.dtype)
        spec_pair, pair_coeff = self.pair_fast
        tb = self.trio_bundle
        r_lo, r_hi = self.respa_switch
        m = self.masses[:, None]
        dof = self.dof

        def short_forces(xx, with_energy=False):
            return pt.trio_short_forces(
                pair_coeff, tb.grid, xx, cell, nbr3,
                spec_pair=spec_pair,
                n_basis_pair=self.n_basis_short,
                spec_l=tb.spec_l, spec_n=tb.spec_n,
                l_basis=tb.l_basis, n_basis=tb.n_basis,
                with_energy=with_energy, active_bc=tb.active_bc,
                window=tb.window, r_lo=r_lo, r_hi=r_hi,
                triangle=tb.symmetric and self.trio_triangle,
                cache3=cache3)

        def tail_forces(xx, with_energy=False):
            return pt.pair_tail_forces(
                pair_coeff, xx, cell, nbr2, spec_pair=spec_pair,
                n_basis_pair=spec_pair.n_basis,
                with_energy=with_energy, r_lo=r_lo, r_hi=r_hi,
                cache2=cache2)

        f_short0, f_tail0 = state.f_short, state.f_tail

        def thermostat_fn(v, key, xi):
            return self._thermostat_update(
                v, key, xi, dt, thermostat, temperature, friction,
                tau, m, dof)

        def outer_body(carry, _):
            x, v, f_short, f_tail, key, xi, stale = carry
            v = v + (0.5 * dt_out) * f_tail / m

            def inner_body(_, c):
                x, v, f_short, key, xi, stale = c
                v = v + 0.5 * dt * f_short / m
                x = x + dt * v
                _, _, f_new = short_forces(x)
                v = v + 0.5 * dt * f_new / m
                v, key, xi = thermostat_fn(v, key, xi)
                stale = stale | nb.needs_rebuild(nbr2, x,
                                                 self.skin_2b)
                if self.two_tier:
                    stale = stale | nb.needs_rebuild(nbr3, x,
                                                     self.skin)
                return (x, v, f_new, key, xi, stale)

            x, v, f_short, key, xi, stale = jax.lax.fori_loop(
                0, n_r, inner_body, (x, v, f_short, key, xi, stale))
            _, f_tail = tail_forces(x)
            v = v + (0.5 * dt_out) * f_tail / m
            return (x, v, f_short, f_tail, key, xi, stale), None

        # staleness is sticky through a multi-cycle launch: a cycle
        # that outran its skin margin must surface even after a later
        # in-launch rebuild resolved it
        carry = (x, state.velocities, f_short0, f_tail0, state.key,
                 state.xi, state.stale)
        carry, _ = jax.lax.scan(outer_body, carry, None,
                                length=n_outer)
        x, v, f_short, f_tail, key, xi, stale = carry
        if compute_energy:
            # chunk-end bookkeeping: potential energy (run() requests
            # this only for the final chunk)
            e2s, e3, f_short = short_forces(x, with_energy=True)
            e2t, f_tail = tail_forces(x, with_energy=True)
            e1 = jnp.sum(self.params.offsets_1b[self.species])
            energy = e1 + e2s + e2t + jnp.sum(e3)
        else:
            energy = state.energy
        return MDState(positions=x, velocities=v,
                       forces=f_short + f_tail, energy=energy,
                       nbr2=nbr2, nbr3=nbr3, key=key, xi=xi,
                       stale=stale, cell=cell, f_short=f_short,
                       f_tail=f_tail)

    def _respa_split_forces_3l(self, state: MDState):
        """(f_pair_short, f_trio, f_tail) at ``state``'s positions --
        the 3-level r-RESPA force partition (respa_mid > 1)."""
        from uf3_tpu.ops import pallas_trio as pt
        spec_pair, pair_coeff = self.pair_fast
        tb = self.trio_bundle
        r_lo, r_hi = self.respa_switch
        cache3 = pt.build_trio_cache(state.nbr3, state.cell,
                                     self.dtype)
        _, f_ps, comps = pt.pair_short_forces(
            pair_coeff, state.positions, state.cell, state.nbr3,
            spec_pair=spec_pair, n_basis_pair=self.n_basis_short,
            with_energy=False, r_lo=r_lo, r_hi=r_hi, cache3=cache3)
        _, f_mid = pt.trio_forces_unrolled(
            tb.grid, state.positions, state.cell, state.nbr3.idx,
            state.nbr3.shift, state.nbr3.mask, state.nbr3.rev,
            spec_l=tb.spec_l, spec_n=tb.spec_n, l_basis=tb.l_basis,
            n_basis=tb.n_basis, with_energy=False,
            active_bc=tb.active_bc, window=tb.window,
            triangle=tb.symmetric and self.trio_triangle,
            cache=cache3, comps=comps)
        _, f_tail = pt.pair_tail_forces(
            pair_coeff, state.positions, state.cell, state.nbr2,
            spec_pair=spec_pair, n_basis_pair=spec_pair.n_basis,
            with_energy=False, r_lo=r_lo, r_hi=r_hi)
        return f_ps, f_mid, f_tail

    def _respa_cycle_3l(self, state: MDState, n_outer: int,
                        dt_fs: float,
                        thermostat: Optional[str],
                        temperature: float,
                        tau_fs: float,
                        friction_ps: float,
                        compute_energy: bool) -> MDState:
        """One traced rebuild cycle of 3-level r-RESPA MD: per outer
        cycle [tail half-kick, n_respa/respa_mid mid cycles, tail
        half-kick]; per mid cycle [trio half-kick, respa_mid inner
        steps on the switched short pair force, trio refresh +
        half-kick].  The trio refresh REUSES the final inner step's
        displacement gather (same positions, same (N, K3) rows), so
        the expensive map + assembly runs once per respa_mid steps at
        no extra gather cost.  Requires state.f_short (pair-short),
        state.f_mid (trio), state.f_tail."""
        from uf3_tpu.ops import pallas_trio as pt
        dt = jnp.asarray(dt_fs * units.fs, dtype=self.dtype)
        friction = friction_ps / units.ps
        tau = tau_fs * units.fs
        n_mid = self.respa_mid
        n_midcycles = self.n_respa // n_mid
        dt_mid = dt * n_mid
        dt_out = dt * self.n_respa
        x, nbr2, nbr3 = self._rebuild_switch(state)
        nbr2 = nbr2._replace(
            overflow=nbr2.overflow | state.nbr2.overflow)
        nbr3 = nbr3._replace(
            overflow=nbr3.overflow | state.nbr3.overflow)
        cell = state.cell
        cache2 = pt.build_pair_cache(nbr2.idx, nbr2.shift, nbr2.mask,
                                     cell, self.dtype)
        cache3 = pt.build_trio_cache(nbr3, cell, self.dtype)
        spec_pair, pair_coeff = self.pair_fast
        tb = self.trio_bundle
        r_lo, r_hi = self.respa_switch
        m = self.masses[:, None]
        dof = self.dof

        def ps_forces(xx, comps=None, with_energy=False):
            return pt.pair_short_forces(
                pair_coeff, xx, cell, nbr3, spec_pair=spec_pair,
                n_basis_pair=self.n_basis_short,
                with_energy=with_energy, r_lo=r_lo, r_hi=r_hi,
                cache3=cache3, comps=comps)

        def trio_forces(xx, comps, with_energy=False):
            return pt.trio_forces_unrolled(
                tb.grid, xx, cell, nbr3.idx, nbr3.shift, nbr3.mask,
                nbr3.rev, spec_l=tb.spec_l, spec_n=tb.spec_n,
                l_basis=tb.l_basis, n_basis=tb.n_basis,
                with_energy=with_energy, active_bc=tb.active_bc,
                window=tb.window,
                triangle=tb.symmetric and self.trio_triangle,
                cache=cache3, comps=comps)

        def tail_forces(xx, with_energy=False):
            return pt.pair_tail_forces(
                pair_coeff, xx, cell, nbr2, spec_pair=spec_pair,
                n_basis_pair=spec_pair.n_basis,
                with_energy=with_energy, r_lo=r_lo, r_hi=r_hi,
                cache2=cache2)

        def thermostat_fn(v, key, xi):
            return self._thermostat_update(
                v, key, xi, dt, thermostat, temperature, friction,
                tau, m, dof)

        def inner_step(x, v, f_ps, key, xi, stale):
            v = v + 0.5 * dt * f_ps / m
            x = x + dt * v
            _, f_new, comps = ps_forces(x)
            v = v + 0.5 * dt * f_new / m
            v, key, xi = thermostat_fn(v, key, xi)
            stale = stale | nb.needs_rebuild(nbr2, x, self.skin_2b)
            if self.two_tier:
                stale = stale | nb.needs_rebuild(nbr3, x, self.skin)
            return x, v, f_new, comps, key, xi, stale

        def mid_body(carry, _):
            x, v, f_ps, f_mid, key, xi, stale = carry
            v = v + 0.5 * dt_mid * f_mid / m

            def ib(_, c):
                x, v, f_ps, key, xi, stale = c
                x, v, f_ps, _, key, xi, stale = inner_step(
                    x, v, f_ps, key, xi, stale)
                return (x, v, f_ps, key, xi, stale)

            if n_mid > 1:
                x, v, f_ps, key, xi, stale = jax.lax.fori_loop(
                    0, n_mid - 1, ib, (x, v, f_ps, key, xi, stale))
            # final inner step keeps its gather for the trio refresh
            x, v, f_ps, comps, key, xi, stale = inner_step(
                x, v, f_ps, key, xi, stale)
            _, f_mid = trio_forces(x, comps)
            v = v + 0.5 * dt_mid * f_mid / m
            return (x, v, f_ps, f_mid, key, xi, stale), None

        def outer_body(carry, _):
            x, v, f_ps, f_mid, f_tail, key, xi, stale = carry
            v = v + 0.5 * dt_out * f_tail / m
            mid_carry = (x, v, f_ps, f_mid, key, xi, stale)
            mid_carry, _ = jax.lax.scan(mid_body, mid_carry, None,
                                        length=n_midcycles)
            x, v, f_ps, f_mid, key, xi, stale = mid_carry
            _, f_tail = tail_forces(x)
            v = v + 0.5 * dt_out * f_tail / m
            return (x, v, f_ps, f_mid, f_tail, key, xi, stale), None

        carry = (x, state.velocities, state.f_short, state.f_mid,
                 state.f_tail, state.key, state.xi, state.stale)
        carry, _ = jax.lax.scan(outer_body, carry, None,
                                length=n_outer)
        x, v, f_ps, f_mid, f_tail, key, xi, stale = carry
        if compute_energy:
            e_ps, f_ps, comps = ps_forces(x, with_energy=True)
            e3, f_mid = trio_forces(x, comps, with_energy=True)
            e_t, f_tail = tail_forces(x, with_energy=True)
            e1 = jnp.sum(self.params.offsets_1b[self.species])
            energy = e1 + e_ps + e_t + jnp.sum(e3)
        else:
            energy = state.energy
        return MDState(positions=x, velocities=v,
                       forces=f_ps + f_mid + f_tail, energy=energy,
                       nbr2=nbr2, nbr3=nbr3, key=key, xi=xi,
                       stale=stale, cell=cell, f_short=f_ps,
                       f_tail=f_tail, f_mid=f_mid)

    def _grow_capacity(self, factor: float = 1.5):
        """Grow neighbor-row and cell-bin capacities (recompiles)."""
        self.capacity_2b = int(np.ceil(self.capacity_2b * factor)) + 1
        if self.degree > 2:
            self.capacity_3b = int(np.ceil(self.capacity_3b
                                           * factor)) + 1
        for attr in ("_cells_2b", "_cells_3b"):
            cells = getattr(self, attr, None)
            if cells is not None:
                grid_shape, bin_cap, topology = cells
                setattr(self, attr,
                        (grid_shape,
                         int(np.ceil(bin_cap * factor)) + 1, topology))

    def _rebuild_state_lists(self, state: MDState) -> MDState:
        """Fresh neighbor lists for ``state`` at current capacities."""
        positions = self._wrap(state.positions, state.cell)
        nbr2, nbr3 = self.build_lists(positions, cell=state.cell,
                                      wrapped=True)
        return state._replace(positions=positions, nbr2=nbr2,
                              nbr3=nbr3)

    def run(self, state: MDState, n_steps: int, dt_fs: float,
            thermostat: Optional[str] = None,
            temperature: float = 300.0,
            tau_fs: float = 100.0,
            friction_ps: float = 2.0,
            on_overflow: str = "raise",
            check_every: int = 50,
            max_regrows: int = 4,
            callback=None,
            launch_chunks: int = 1,
            sync: bool = True) -> MDState:
        """
        Run n_steps of MD, rebuilding neighbor lists every
        rebuild_every steps; a host loop over one compiled launch of
        ``launch_chunks`` rebuild cycles so every launch reuses the
        same executable.

        ``launch_chunks > 1`` (r-RESPA path) scans whole rebuild
        cycles inside one jit launch, so the host dispatches once per
        ``launch_chunks`` cycles instead of once per rebuild cycle.
        Callbacks, overflow polling, and regrow snapshots then
        operate at launch granularity.

        ``callback(state, steps_done)``, when given, fires after every
        committed launch (a host sync each) -- the hook for trajectory
        writers (`forcefield.batch.TrajectoryWriter`), live monitors,
        or custom checkpointing.

        Neighbor-capacity overflow (silent pair truncation) is
        detected without stalling the dispatch pipeline: each launch's
        overflow flag is queued and polled on the host as soon as its
        transfer completes (``jax.Array.is_ready``, no sync), with a
        hard host sync only once the backlog reaches ``check_every``
        launches.  With ``sync=True`` (default) every flag queued by
        THIS call is drained before returning (one host sync at the
        end of the run), so an overflow cannot survive the run()
        call.  ``sync=False`` keeps the fully-asynchronous pipeline
        (an overflow may surface from a LATER run() call or an
        explicit ``overflowed(state)`` check) -- the mode for
        back-to-back launch pipelining, as bench.py uses.
        ``on_overflow``:

        - "raise": RuntimeError once a queued flag reads True
          (default);
        - "warn": warnings.warn per detected overflow, keep going.
          Truncation errors are real, and with the default pack
          cell-list selection the dropped pairs are NOT guaranteed
          to be the farthest (stencil-order drops) -- prefer
          "regrow" when overflow is plausible;
        - "regrow": revert the offending chunk, grow row/bin
          capacities 1.5x (recompiles) and re-run it -- a capacity
          bust mid-run costs one chunk retry instead of corrupt
          forces.  Implies a host sync per chunk.
        """
        inner = min(self.rebuild_every, n_steps)
        any_stale = jnp.zeros((), dtype=bool)
        remaining = n_steps
        regrows = 0
        if on_overflow == "regrow":
            # flags left queued by a previous async run: in regrow
            # mode a hit grows capacity instead of raising advice to
            # use the mode the caller is already in
            if self._drain_pending():
                self._grow_capacity()
                state = self._rebuild_state_lists(state)
        else:
            self._poll_overflow(on_overflow, check_every)
        while remaining > 0:
            snapshot = state if on_overflow == "regrow" else None
            if self.n_respa > 1 and remaining >= self.n_respa:
                n_outer = max(1, min(inner, remaining)
                              // self.n_respa)
                chunk_steps = n_outer * self.n_respa
                n_chunks = max(1, min(launch_chunks,
                                      remaining // chunk_steps))
                steps = n_chunks * chunk_steps
                state = self._run_chunk_respa(
                    state, n_outer=n_outer, dt_fs=dt_fs,
                    thermostat=thermostat, temperature=temperature,
                    tau_fs=tau_fs, friction_ps=friction_ps,
                    compute_energy=(remaining - steps
                                    < self.n_respa),
                    n_chunks=n_chunks)
            else:
                chunk_steps = min(inner, remaining)
                n_chunks = max(1, min(launch_chunks,
                                      remaining // chunk_steps))
                steps = n_chunks * chunk_steps
                state = self._run_chunk(state, n_steps=chunk_steps,
                                        dt_fs=dt_fs,
                                        thermostat=thermostat,
                                        temperature=temperature,
                                        tau_fs=tau_fs,
                                        friction_ps=friction_ps,
                                        n_chunks=n_chunks)
            if on_overflow == "regrow":
                if self.overflowed(state):
                    if regrows >= max_regrows:
                        raise RuntimeError(
                            "neighbor capacity still overflowing "
                            f"after {regrows} regrows")
                    regrows += 1
                    self._grow_capacity()
                    state = self._rebuild_state_lists(snapshot)
                    continue
            else:
                over = state.nbr2.overflow
                if state.nbr3 is not None:
                    over = over | state.nbr3.overflow
                self._pending_overflow.append(over)
                # reset the carried flags so each queued entry covers
                # exactly one launch: without this a single overflow
                # stays OR-sticky across every later launch (repeated
                # warnings, and recovery becomes indistinguishable)
                false_flag = jnp.zeros((), dtype=bool)
                nbr2 = state.nbr2._replace(overflow=false_flag)
                nbr3 = state.nbr3._replace(overflow=false_flag) \
                    if state.nbr3 is not None else None
                state = state._replace(nbr2=nbr2, nbr3=nbr3)
                self._poll_overflow(on_overflow, check_every)
            any_stale = any_stale | state.stale
            remaining -= steps
            if callback is not None:
                callback(state, n_steps - remaining)
        if on_overflow != "regrow":
            if sync:
                # synchronous guarantee: every flag queued by this
                # run is resolved before returning (one host sync)
                if self._drain_pending(warn=(on_overflow == "warn")):
                    if on_overflow != "warn":
                        self._report_overflow(on_overflow)
            else:
                self._poll_overflow(on_overflow, check_every)
        return state._replace(stale=any_stale)

    def _drain_pending(self, warn: bool = False) -> bool:
        """Blockingly resolve ALL queued overflow flags; returns
        whether any was set.  With ``warn=True`` each hit emits its
        own warning as it is found."""
        hit = False
        for flag in self._pending_overflow:
            if bool(flag):
                hit = True
                if warn:
                    self._report_overflow("warn")
        self._pending_overflow.clear()
        return hit

    def _poll_overflow(self, on_overflow: str, check_every: int):
        """Resolve queued per-launch overflow flags without blocking:
        pop every flag whose device->host transfer already finished;
        block on the oldest only when the backlog reaches
        ``check_every`` (bounds how long an overflow can stay
        undetected).  Chunks execute in dispatch order, so draining
        from the front never waits on an unfinished chunk while a
        finished one goes unchecked.  In 'warn' mode a hit keeps
        draining (later distinct overflows each surface); in 'raise'
        mode the remaining backlog is discarded before raising."""
        pending = self._pending_overflow
        while pending and (pending[0].is_ready()
                           or len(pending) >= max(1, check_every)):
            if bool(pending.pop(0)):
                if on_overflow != "warn":
                    pending.clear()
                self._report_overflow(on_overflow)

    @staticmethod
    def _report_overflow(on_overflow: str):
        message = ("neighbor capacity exceeded during MD: pairs were "
                   "dropped at a rebuild (farthest-first for the "
                   "O(N^2) builders; stencil-order for the default "
                   "pack cell list); increase capacity_2b/capacity_3b "
                   "(or use on_overflow='regrow')")
        if on_overflow == "warn":
            import warnings
            warnings.warn(message)
        else:
            raise RuntimeError(message)

    # -- pressure coupling --------------------------------------------------
    def npt_run(self, state: MDState, n_steps: int, dt_fs: float,
                temperature: float = 300.0,
                pressure: float = 0.0,
                tau_p_fs: float = 1000.0,
                compressibility: float = 5e-3,
                friction_ps: float = 2.0,
                barostat: str = "scr",
                atoms_template=None,
                callback=None,
                launch_chunks: int = 1):
        """
        NPT molecular dynamics (Langevin thermostat).  Barostats:

        - "scr" (default): per-step stochastic cell rescaling
          integrated inside the jit chunk [Bernetti & Bussi, J. Chem.
          Phys. 153, 114107 (2020)]: d(ln V) = -beta_T/tau_p
          (P0 - P_int) dt + sqrt(2 kB T beta_T / (V tau_p)) dW with
          the pressure from the analytic fused-kernel virial every
          step.  Samples the true NPT ensemble -- the on-device
          counterpart of the reference's LAMMPS Nose-Hoover NPT
          melting protocol (supplement/melting_point/melting_uf.in).
        - "berendsen": legacy per-chunk Berendsen rescale by
          (1 - dt/tau_p * beta * (P0 - P))^(1/3) (approximate; does
          not sample the NPT ensemble).

        ``launch_chunks > 1`` scans whole rebuild cycles inside one
        jit launch (scr only; same dispatch amortization as run()),
        with the overflow check, regrow snapshots and cell history at
        launch granularity.

        Returns (state, cell_history: one (3, 3) cell per launch).
        The system's cell is mutated; neighbor capacities absorb
        density changes by regrow-on-overflow.
        """
        cells = []
        inner = min(self.rebuild_every, n_steps)
        done = 0
        regrows = 0
        max_regrows = 4
        while done < n_steps:
            steps = min(inner, n_steps - done)
            snapshot = state
            if barostat == "scr":
                n_chunks = max(1, min(launch_chunks,
                                      (n_steps - done) // steps))
                steps = n_chunks * steps
                state = self._run_chunk(
                    state, n_steps=min(inner, n_steps - done),
                    dt_fs=dt_fs,
                    thermostat="langevin", temperature=temperature,
                    friction_ps=friction_ps, barostat="scr",
                    pressure=pressure, tau_p_fs=tau_p_fs,
                    compressibility=compressibility,
                    n_chunks=n_chunks)
                if self.overflowed(state):
                    if regrows >= max_regrows:
                        raise RuntimeError(
                            "neighbor capacity still overflows after "
                            f"{regrows} regrows -- the NPT run is "
                            "likely unstable (collapsing cell or "
                            "diverging positions)")
                    regrows += 1
                    self._grow_capacity()
                    state = self._rebuild_state_lists(snapshot)
                    continue
                done += steps
                cells.append(np.asarray(state.cell))
                if callback is not None:
                    callback(state, done)
                continue
            state = self._run_chunk(state, n_steps=steps, dt_fs=dt_fs,
                                    thermostat="langevin",
                                    temperature=temperature,
                                    friction_ps=friction_ps)
            if self.overflowed(state):
                # density change outran the capacities: revert, grow
                # row/bin capacities, and redo the chunk rather than
                # continue on dropped pairs
                if regrows >= max_regrows:
                    raise RuntimeError(
                        "neighbor capacity still overflows after "
                        f"{regrows} regrows -- the NPT run is likely "
                        "unstable (collapsing cell or diverging "
                        "positions)")
                regrows += 1
                self._grow_capacity()
                state = self._rebuild_state_lists(snapshot)
                continue
            done += steps
            stress = self.stress(state)
            m = self.masses[:, None]
            ke = 0.5 * jnp.sum(m * state.velocities ** 2)
            volume = float(jnp.abs(jnp.linalg.det(state.cell)))
            virial_pressure = (-(stress[0] + stress[1] + stress[2]) / 3.0
                               + 2.0 * ke / (3.0 * volume))
            scale = (1.0 - (dt_fs * steps / tau_p_fs) * compressibility
                     * (pressure - float(virial_pressure))) ** (1.0 / 3.0)
            state = state._replace(positions=state.positions * scale,
                                   cell=state.cell * scale)
            cells.append(np.asarray(state.cell))
            if callback is not None:
                callback(state, done)
        return state, cells

    def overflowed(self, state: MDState) -> bool:
        """True when a neighbor capacity was exceeded at the last
        build: pairs were silently dropped (nearest kept) -- raise
        capacity_2b / capacity_3b.  Host sync; call between chunks."""
        flag = state.nbr2.overflow
        if state.nbr3 is not None:
            flag = flag | state.nbr3.overflow
        # also drain any overflow flags still queued from past chunks
        # (async detection in run()): this is the synchronous check
        queued = self._drain_pending()
        return bool(flag) or queued

    # -- observables --------------------------------------------------------
    def temperature(self, state: MDState) -> float:
        m = self.masses[:, None]
        v = state.velocities if self.mobile_mask is None \
            else state.velocities * self.mobile_mask[:, None]
        ke = 0.5 * jnp.sum(m * v ** 2)
        return float(2.0 * ke / (self.dof * units.kB))

    def kinetic_energy(self, state: MDState) -> float:
        m = self.masses[:, None]
        return float(0.5 * jnp.sum(m * state.velocities ** 2))

    def stress(self, state: MDState):
        """Voigt stress from the analytic virial (fused fast path)."""
        _, _, virial = self.energy_forces(state.positions, state.nbr2,
                                          state.nbr3, cell=state.cell,
                                          with_virial=True)
        volume = jnp.abs(jnp.linalg.det(state.cell))
        return pot.stress_voigt(virial, volume)

    def to_atoms(self, atoms_template: Atoms, state: MDState) -> Atoms:
        out = atoms_template.copy()
        out.set_positions(np.asarray(state.positions))
        out.set_array("velocities", np.asarray(state.velocities))
        return out
