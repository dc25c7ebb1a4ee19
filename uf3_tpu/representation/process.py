"""
BasisFeaturizer: drives per-configuration featurization (1B composition +
2B + compressed-3B), arranges energy/force feature rows into DataFrames,
and streams chunked feature tables to an HDF5 store.

Row layout parity with the reference (uf3/representation/process.py:20-535):
one energy row plus 3 * n_atoms force rows per configuration; columns are
[y, n_<el>..., <interaction features>...].  The HDF5 store here is a plain
h5py layout (the reference uses pandas/pytables) with the same
chunk-naming scheme (features_000, ...) and restartable writes.
"""

from __future__ import annotations

import os
import warnings
from typing import TYPE_CHECKING, Dict, List, Tuple

import numpy as np

from uf3_tpu.data import geometry as geo
from uf3_tpu.data.atoms import Atoms
from uf3_tpu.representation import featurize_np as fnp
from uf3_tpu.representation.basis import BSplineBasis

if TYPE_CHECKING:  # pandas is needed only by the DataFrame helpers
    import pandas as pd


def flatten_by_interactions(vector_map: Dict, pair_tuples: List) -> np.ndarray:
    return np.concatenate([vector_map[pair] for pair in pair_tuples], axis=-1)


class BasisFeaturizer:
    """Generate energy/force features from configurations."""

    def __init__(self, bspline_config: BSplineBasis,
                 fit_forces: bool = True, prefix: str = "x"):
        self.bspline_config = bspline_config
        self.fit_forces = fit_forces
        self.prefix = prefix
        self.columns = bspline_config.get_column_names()

    # -- passthrough properties --------------------------------------------
    @property
    def chemical_system(self):
        return self.bspline_config.chemical_system

    @property
    def degree(self):
        return self.chemical_system.degree

    @property
    def element_list(self):
        return self.chemical_system.element_list

    @property
    def interactions_map(self):
        return self.chemical_system.interactions_map

    @property
    def r_cut(self):
        return self.bspline_config.r_cut

    @property
    def knots_map(self):
        return self.bspline_config.knots_map

    @property
    def interaction_hashes(self):
        return self.chemical_system.interaction_hashes

    @property
    def leading_trim(self):
        return self.bspline_config.leading_trim

    @property
    def trailing_trim(self):
        return self.bspline_config.trailing_trim

    @staticmethod
    def from_config(bspline_config, config):
        keys = ["prefix", "fit_forces"]
        config = {k: v for k, v in config.items() if k in keys}
        return BasisFeaturizer(bspline_config, **config)

    def __repr__(self):
        return "\n".join(["BasisFeaturizer:",
                          f"    Fit forces: {self.fit_forces}",
                          f"    Column prefix: {self.prefix}",
                          repr(self.bspline_config)])

    # -- per-configuration featurization ------------------------------------
    def featurize_energy_2B(self, geom: Atoms,
                            supercell: Atoms = None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        pair_tuples = self.interactions_map[2]
        distances_map = fnp.distances_by_interaction(
            geom, pair_tuples, self.bspline_config.r_min_map,
            self.bspline_config.r_max_map, supercell=supercell)
        feature_map = {
            pair: fnp.energy_features_2b(distances_map[pair],
                                         self.knots_map[pair],
                                         self.leading_trim[2],
                                         self.trailing_trim[2])
            for pair in pair_tuples}
        return flatten_by_interactions(feature_map, pair_tuples)

    def featurize_force_2B(self, geom: Atoms,
                           supercell: Atoms = None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        pair_tuples = self.interactions_map[2]
        dist_map, deriv_map = fnp.derivatives_by_interaction(
            geom, pair_tuples, self.r_cut,
            self.bspline_config.r_min_map, self.bspline_config.r_max_map,
            supercell)
        feature_map = {}
        for pair in pair_tuples:
            i_idx, j_idx, unit = deriv_map[pair]
            feature_map[pair] = fnp.force_features_2b(
                dist_map[pair], i_idx, j_idx, unit, len(geom),
                self.knots_map[pair],
                self.leading_trim[2], self.trailing_trim[2])
        return flatten_by_interactions(feature_map, pair_tuples)

    def featurize_energy_3B(self, geom: Atoms,
                            supercell: Atoms = None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        trio_list = self.interactions_map[3]
        knot_sets = [self.knots_map[trio] for trio in trio_list]
        grids = fnp.energy_grids_3b(geom, knot_sets,
                                    self.interaction_hashes[3],
                                    supercell=supercell,
                                    n_lead=self.leading_trim[3],
                                    n_trail=self.trailing_trim[3])
        vectors = [self.bspline_config.compress_3B(grids[i], trio)
                   for i, trio in enumerate(trio_list)]
        return np.concatenate(vectors)

    def featurize_force_3B(self, geom: Atoms,
                           supercell: Atoms = None) -> np.ndarray:
        if supercell is None:
            supercell = geom
        trio_list = self.interactions_map[3]
        knot_sets = [self.knots_map[trio] for trio in trio_list]
        grids = fnp.force_grids_3b(geom, knot_sets,
                                   self.interaction_hashes[3],
                                   supercell=supercell,
                                   n_lead=self.leading_trim[3],
                                   n_trail=self.trailing_trim[3])
        blocks = []
        for i, trio in enumerate(trio_list):
            per_interaction = grids[i]  # (n_atoms, 3, L, M, N)
            n_atoms = per_interaction.shape[0]
            block = np.stack([
                np.stack([self.bspline_config.compress_3B(
                    per_interaction[a, c], trio) for c in range(3)])
                for a in range(n_atoms)])
            blocks.append(block)
        return np.concatenate(blocks, axis=-1)

    def evaluate_configuration(self,
                               geom: Atoms,
                               name: str = None,
                               energy: float = None,
                               forces=None,
                               energy_key: str = "energy") -> Dict:
        """One energy row and/or 3N force rows of features for a config."""
        eval_map = {}
        n_atoms = len(geom)
        invalid = set(geom.get_chemical_symbols()) - set(self.element_list)
        if invalid:
            warnings.warn(f"Invalid elements: {', '.join(sorted(invalid))}",
                          RuntimeWarning)
            return {}
        if np.any(geom.get_pbc()):
            supercell = geo.get_supercell(geom, r_cut=self.r_cut)
        else:
            supercell = geom
        if energy is not None:
            vector = np.concatenate([
                self.chemical_system.get_composition_tuple(geom),
                self.featurize_energy_2B(geom, supercell)])
            if self.degree > 2:
                vector = np.concatenate(
                    [vector, self.featurize_energy_3B(geom, supercell)])
            key = (name, energy_key) if name is not None else energy_key
            eval_map[key] = np.insert(vector, 0, energy)
        if forces is not None:
            vectors = np.concatenate([
                np.zeros((n_atoms, 3, len(self.element_list))),
                self.featurize_force_2B(geom, supercell)], axis=2)
            if self.degree > 2:
                vectors = np.concatenate(
                    [vectors, self.featurize_force_3B(geom, supercell)],
                    axis=2)
            for c, component in enumerate(["fx", "fy", "fz"]):
                for a in range(n_atoms):
                    row = np.insert(vectors[a, c, :], 0, forces[c][a])
                    tag = f"{component}_{a}"
                    key = (name, tag) if name is not None else tag
                    eval_map[key] = row
        return eval_map

    # -- dataframe orchestration --------------------------------------------
    def evaluate(self,
                 df_data: pd.DataFrame,
                 atoms_key: str = "geometry",
                 energy_key: str = "energy",
                 progress=None) -> pd.DataFrame:
        """Featurize every configuration of a standard dataframe."""
        import pandas as pd
        eval_map = {}
        has_energy = energy_key in df_data.columns
        has_forces = all(k in df_data.columns for k in ("fx", "fy", "fz"))
        for name, row in df_data.iterrows():
            geom = row[atoms_key]
            energy = row[energy_key] if has_energy else None
            forces = None
            if has_forces and self.fit_forces:
                forces = [row["fx"], row["fy"], row["fz"]]
                if any(f is None for f in forces) \
                        or np.any(pd.isna(np.concatenate(
                            [np.atleast_1d(f) for f in forces]))):
                    forces = None
            eval_map.update(self.evaluate_configuration(
                geom, name, energy, forces, energy_key))
        df_features = pd.DataFrame.from_dict(eval_map, orient="index",
                                             columns=self.columns)
        df_features.index = pd.MultiIndex.from_tuples(df_features.index)
        return df_features

    def evaluate_parallel(self, df_data, client=None, n_jobs=1, **kwargs):
        """
        Featurize using a process pool (concurrent.futures API).  The
        device-parallel path lives in uf3_tpu.ops.featurize_jax; this
        host pool mirrors the reference's dask/futures backend.
        """
        kwargs.pop("progress", None)
        if client is None or n_jobs < 2:
            return self.evaluate(df_data, **kwargs)
        from uf3_tpu.util import parallel as par
        batches = par.split_dataframe(df_data, n_jobs)
        futures = par.batch_submit(self.evaluate, batches, client, **kwargs)
        df_features = par.gather_and_merge(futures, client=client)
        return df_features.loc[df_data.index, :]

    def batched_to_hdf(self,
                       filename: str,
                       df_data: pd.DataFrame,
                       client=None,
                       n_jobs: int = 1,
                       batch_size: int = 50,
                       table_template: str = "features_{}",
                       progress=None,
                       **kwargs) -> None:
        """Restartable chunked featurization into an HDF5 feature store."""
        idx_all = np.arange(len(df_data))
        idx_batches = np.array_split(
            idx_all, np.maximum(1, len(idx_all[batch_size::batch_size]) + 1))
        magnitude = max(int(np.ceil(np.log10(len(idx_batches)) + 0.1)), 3)
        existing = []
        if os.path.isfile(filename):
            _, _, existing, _ = analyze_hdf_tables(filename)
            warnings.warn(f"File already exists: contains {len(existing)} "
                          f"chunks.", RuntimeWarning)
        for j, idx_batch in enumerate(idx_batches):
            table_name = table_template.format(str(j).rjust(magnitude, "0"))
            if table_name in existing:
                continue
            df_features = self.evaluate_parallel(
                df_data.iloc[idx_batch], client, n_jobs=n_jobs, **kwargs)
            save_feature_db(df_features, filename, table_name=table_name)


# ---------------------------------------------------------------------------
# HDF5 feature store (h5py layout)
# ---------------------------------------------------------------------------
def save_feature_db(dataframe: pd.DataFrame, filename: str,
                    table_name: str = "features") -> None:
    """Write one feature chunk: values + row index + column names."""
    import h5py
    import pandas as pd
    with h5py.File(filename, "a") as f:
        if table_name in f:
            del f[table_name]
        group = f.create_group(table_name)
        group.create_dataset("values",
                             data=dataframe.to_numpy(dtype=np.float64),
                             compression="gzip", compression_opts=1)
        index = dataframe.index
        if isinstance(index, pd.MultiIndex):
            names = [str(t[0]) for t in index]
            kinds = [str(t[1]) for t in index]
        else:
            names = [str(t) for t in index]
            kinds = [""] * len(index)
        str_dtype = h5py.string_dtype()
        group.create_dataset("row_names", data=names, dtype=str_dtype)
        group.create_dataset("row_kinds", data=kinds, dtype=str_dtype)
        group.create_dataset("columns", data=[str(c) for c in
                                              dataframe.columns],
                             dtype=str_dtype)


def load_feature_db(filename: str,
                    table_name: str = "features") -> pd.DataFrame:
    import h5py
    import pandas as pd
    with h5py.File(filename, "r") as f:
        group = f[table_name]
        values = group["values"][()]
        names = [s.decode() for s in group["row_names"][()]]
        kinds = [s.decode() for s in group["row_kinds"][()]]
        columns = [s.decode() for s in group["columns"][()]]
    index = pd.MultiIndex.from_arrays([names, kinds])
    return pd.DataFrame(values, index=index, columns=columns)


def analyze_hdf_tables(filename: str) -> Tuple[int, int, List, Dict]:
    import h5py
    chunk_lengths = {}
    with h5py.File(filename, "r") as f:
        for name in f.keys():
            chunk_lengths[name] = f[name]["values"].shape[0]
    chunk_names = sorted(chunk_lengths)
    n_entries = int(np.sum(list(chunk_lengths.values()) or [0]))
    return len(chunk_lengths), n_entries, chunk_names, chunk_lengths


def dataframe_batch_loader(filename: str, table_names: List[str]):
    for table_name in table_names:
        yield load_feature_db(filename, table_name)
