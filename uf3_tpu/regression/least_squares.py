"""
Weighted regularized linear least squares for UF potentials.

Normal-equation training: accumulate Gram (X^T X) and ordinate (X^T y)
over energy/force feature batches, blend them with per-channel
1/(sqrt(n) * sigma) weights and the energy/force balance kappa, add the
squared regularizer, eliminate frozen (trimmed) columns, and solve.
Semantics parity with uf3/regression/least_squares.py:144-891; the Gram
accumulation has a device-sharded twin in uf3_tpu/parallel/mesh.py.
"""

from __future__ import annotations

import os
import warnings
from typing import TYPE_CHECKING, Collection, Dict, List, Tuple

import numpy as np

from uf3_tpu.data import composition
from uf3_tpu.representation import splines as sp
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu.util import json_io

if TYPE_CHECKING:  # pandas is needed only by the DataFrame helpers
    import pandas as pd


class VarianceRecorder:
    """Streaming population mean/std over batches.

    Internally carries Chan-style moments (count, mean, M2 = summed
    squared deviations), which merge exactly across batches of any
    size; ``mean``/``std`` are derived views of the moments.  Used by
    the fit pipeline to size the 1/(sqrt(n) sigma) channel weights
    (reference semantics: uf3/regression/least_squares.py:19-60).
    """

    def __init__(self, mean=0, std=0, n=0):
        self.n = int(n)
        self._mean = np.asarray(mean, dtype=float) if n else 0.0
        self._m2 = (np.asarray(std, dtype=float) ** 2 * n) if n else 0.0

    @property
    def mean(self):
        return self._mean

    @property
    def std(self):
        return np.sqrt(self._m2 / self.n) if self.n else 0.0

    def update(self, batch: Collection) -> Tuple:
        batch = np.asarray(batch, dtype=float)
        n_b = len(batch)
        if n_b:
            mean_b = batch.mean(axis=0)
            m2_b = ((batch - mean_b) ** 2).sum(axis=0)
            total = self.n + n_b
            delta = mean_b - self._mean
            self._m2 = (self._m2 + m2_b
                        + delta * delta * (self.n * n_b / total))
            self._mean = self._mean + delta * (n_b / total)
            self.n = total
        return self.mean, self.std, self.n

    def update_with_components(self, df: pd.DataFrame, keys=None):
        """Fold the flattened force components of ``df`` into the
        stream, skipping rows with missing entries."""
        keys = keys or ["fx", "fy", "fz"]
        for _, row in df[keys].iterrows():
            cols = [row[k] for k in keys]
            if any(c is None or (np.isscalar(c) and pd.isna(c))
                   for c in cols):
                continue
            self.update(np.concatenate(
                [np.ravel(np.asarray(c, dtype=float)) for c in cols]))
        return self.mean, self.std, self.n


# ---------------------------------------------------------------------------
# gram/ordinate primitives
# ---------------------------------------------------------------------------
def moore_penrose_components(x: np.ndarray,
                             y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Gram matrix (X^T X) and ordinate (X^T y)."""
    return np.dot(x.T, x), np.dot(x.T, y)


def batched_moore_penrose(x, y, batch_size: int = 2500):
    """Accumulate gram/ordinate over row batches to bound memory."""
    n_samples, n_features = np.shape(x)
    n_batches = int(n_samples / batch_size)
    if n_batches <= 1:
        return moore_penrose_components(x, y)
    gram = np.zeros((n_features, n_features))
    ordinate = np.zeros(n_features)
    for batch in np.array_split(np.arange(n_samples), n_batches):
        g, o = moore_penrose_components(x[batch], y[batch])
        gram += g
        ordinate += o
    return gram, ordinate


def lu_factorization(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.solve(a, b)


def linear_least_squares(x, y):
    a, b = moore_penrose_components(x, y)
    return lu_factorization(a, b)


def apply_weights(x, y, weights):
    if weights is None:
        return x, y
    if len(weights) != len(x):
        raise ValueError("Number of weights does not match samples.")
    if not np.all(np.asarray(weights) >= 0):
        raise ValueError("Negative weights provided.")
    w = np.sqrt(weights)
    return np.multiply(x.T, w).T, np.multiply(y, w)


def weighted_least_squares(x, y, weights=None, regularizer=None):
    x_fit, y_fit = apply_weights(x, y, weights)
    if regularizer is not None:
        x_fit = np.concatenate([x_fit, regularizer])
        y_fit = np.concatenate([y_fit, np.zeros(len(regularizer))])
    return linear_least_squares(x_fit, y_fit)


# ---------------------------------------------------------------------------
# frozen-column elimination
# ---------------------------------------------------------------------------
def get_freezing_mask(n_feats: int, col_idx: np.ndarray) -> np.ndarray:
    return np.setdiff1d(np.arange(n_feats), col_idx)


def freeze_columns(x, y, mask, frozen_c, col_idx):
    """Eliminate frozen columns, moving their contribution into y."""
    x = np.asarray(x)
    x_fixed = x[:, col_idx]
    return x[:, mask], np.subtract(y, np.dot(x_fixed, frozen_c))


def freeze_regularizer(regularizer, mask):
    return regularizer[:, mask]


def revert_frozen_coefficients(solution, n_coeff, mask, frozen_c,
                               frozen_idx) -> np.ndarray:
    full = np.zeros(n_coeff, dtype=np.asarray(solution).dtype)
    full[np.asarray(mask, dtype=int)] = solution
    full[np.asarray(frozen_idx, dtype=int)] = frozen_c
    return full


def calc_E_F_weights(n_e, n_f, std_e, std_f) -> Tuple[float, float]:
    """Per-channel weights 1/(sqrt(n) * sigma); degenerate energies fall
    back to weight 1 (reference least_squares.py:1147-1169)."""
    if std_e == 0:
        return 1.0, 1.0 / np.sqrt(n_f)
    return 1.0 / np.sqrt(n_e) / std_e, 1.0 / np.sqrt(n_f) / std_f


# ---------------------------------------------------------------------------
# dataframe extraction
# ---------------------------------------------------------------------------
def dataframe_to_tuples(df_features: pd.DataFrame,
                        n_elements: int = None,
                        energy_key: str = "energy",
                        sample_weights: Dict = None):
    """
    Split feature rows into energy and force channels; energy rows are
    normalized per atom via the 1-body composition columns.
    """
    names = df_features.index.get_level_values(0)
    kinds = df_features.index.get_level_values(-1)
    energy_mask = np.asarray(kinds == energy_key)
    force_mask = ~energy_mask
    data = df_features.to_numpy(dtype=np.float64)
    y = data[:, 0]
    x = data[:, 1:]
    y_e = y[energy_mask]
    y_f = y[force_mask]
    if n_elements is not None:
        sizes = np.sum(x[energy_mask, :n_elements], axis=1)
        x_e = x[energy_mask] / sizes[:, None]
        y_e = y_e / sizes
    else:
        x_e = x[energy_mask]
    x_f = x[force_mask]
    if sample_weights is not None:
        w = np.array([sample_weights.get(name, 1.0) for name in names])
        x_e = x_e * w[energy_mask][:, None]
        y_e = y_e * w[energy_mask]
        x_f = x_f * w[force_mask][:, None]
        y_f = y_f * w[force_mask]
    return x_e, y_e, x_f, y_f


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
class BasicLinearModel:
    """Plain regularized linear regression."""

    def __init__(self, regularizer: np.ndarray = None):
        self.coefficients = None
        self.regularizer = regularizer

    def fit(self, x, y, ridge_penalty: float = 1e-8):
        gram, ordinate = moore_penrose_components(x, y)
        reg = (np.eye(len(gram)) * ridge_penalty
               if self.regularizer is None else self.regularizer)
        self.coefficients = lu_factorization(gram + reg.T @ reg, ordinate)

    def predict(self, x):
        return np.dot(x, self.coefficients)

    def score(self, x, y, weights=None, normalize=True):
        if weights is not None:
            x, y = apply_weights(x, y, weights)
        score = -rmse_metric(y, self.predict(x))
        if normalize:
            score /= np.std(y)
        return score


class WeightedLinearModel(BasicLinearModel):
    """Energy+force weighted regularized least squares over a basis set."""

    def __init__(self,
                 bspline_config: BSplineBasis,
                 regularizer: np.ndarray = None,
                 data_coverage: np.ndarray = None,
                 **params):
        super().__init__(regularizer)
        self.bspline_config = bspline_config
        n_basis = self.n_feats
        if data_coverage is not None:
            if len(data_coverage) != n_basis:
                raise ValueError(f"Incorrect data_coverage shape: "
                                 f"{len(data_coverage)} != {n_basis}")
            self.data_coverage = np.asarray(data_coverage, dtype=bool)
        else:
            self.data_coverage = np.zeros(n_basis, dtype=bool)
        if self.regularizer is None:
            self.set_params(**params)

    def set_params(self, **params):
        self.bspline_config = params.get("bspline_config",
                                         self.bspline_config)
        try:
            self.regularizer = params["regularizer"]
        except KeyError:
            pass
        if "regularizer" not in params and self.regularizer is None:
            scalars = {k: v for k, v in params.items()
                       if isinstance(v, (int, float, np.floating))}
            self.regularizer = \
                self.bspline_config.get_regularization_matrix(**scalars)

    # -- delegation views onto the basis config ------------------------------
    n_feats = property(lambda self: self.bspline_config.n_feats)
    frozen_c = property(lambda self: self.bspline_config.frozen_c)
    col_idx = property(lambda self: self.bspline_config.col_idx)
    mask = property(
        lambda self: get_freezing_mask(self.n_feats, self.col_idx))

    def __repr__(self):
        fit = "True" if self.coefficients is not None else "False"
        return "\n".join(["WeightedLinearModel:", f"    Fit: {fit}",
                          repr(self.bspline_config)])

    # -- fitting ------------------------------------------------------------
    def fit_with_gram(self, gram: np.ndarray, ordinate: np.ndarray):
        coverage = (np.sum(gram, axis=0) != 0)
        coverage = revert_frozen_coefficients(coverage, self.n_feats,
                                              self.mask, self.frozen_c,
                                              self.col_idx)
        self.data_coverage = np.logical_or(self.data_coverage,
                                           coverage.astype(bool))
        reg = freeze_regularizer(self.regularizer, self.mask)
        coefficients = lu_factorization(gram + reg.T @ reg, ordinate)
        self.coefficients = revert_frozen_coefficients(
            coefficients, self.n_feats, self.mask, self.frozen_c,
            self.col_idx)

    def fit(self, x_e, y_e, x_f=None, y_f=None, weight: float = 0.5,
            batch_size: int = 2500):
        x_e, y_e = freeze_columns(x_e, y_e, self.mask, self.frozen_c,
                                  self.col_idx)
        gram_e, ord_e = batched_moore_penrose(x_e, y_e,
                                              batch_size=batch_size)
        if x_f is not None:
            energy_weight, force_weight = calc_E_F_weights(
                len(y_e), len(y_f), np.std(y_e), np.std(y_f))
            x_f, y_f = freeze_columns(x_f, y_f, self.mask, self.frozen_c,
                                      self.col_idx)
            gram_f, ord_f = batched_moore_penrose(x_f, y_f,
                                                  batch_size=batch_size)
            gram, ordinate = self.combine_weighted_gram(
                gram_e, gram_f, ord_e, ord_f,
                energy_weight, force_weight, weight)
        else:
            gram, ordinate = gram_e, ord_e
        self.fit_with_gram(gram, ordinate)

    @staticmethod
    def combine_weighted_gram(gram_e, gram_f, ord_e, ord_f,
                              energy_weight, force_weight, weight):
        gram = (weight * energy_weight ** 2 * gram_e
                + (1 - weight) * force_weight ** 2 * gram_f)
        ordinate = (weight * energy_weight ** 2 * ord_e
                    + (1 - weight) * force_weight ** 2 * ord_f)
        return gram, ordinate

    def initialize_gram_ordinate(self):
        n_columns = self.n_feats - len(self.col_idx)
        return (np.zeros((n_columns, n_columns)), np.zeros(
            (n_columns, n_columns)), np.zeros(n_columns),
            np.zeros(n_columns))

    def gram_from_df(self, df: pd.DataFrame, keys,
                     e_variance: VarianceRecorder = None,
                     f_variance: VarianceRecorder = None,
                     sample_weights: Dict = None,
                     energy_key: str = "energy",
                     batch_size: int = 2500):
        n_elements = len(self.bspline_config.element_list)
        x_e, y_e, x_f, y_f = dataframe_to_tuples(
            df.loc[keys], n_elements=n_elements, energy_key=energy_key,
            sample_weights=sample_weights)
        x_e, y_e = freeze_columns(x_e, y_e, self.mask, self.frozen_c,
                                  self.col_idx)
        x_f, y_f = freeze_columns(x_f, y_f, self.mask, self.frozen_c,
                                  self.col_idx)
        if e_variance is not None and f_variance is not None:
            e_variance.update(y_e)
            f_variance.update(y_f)
        gram_e, ord_e = batched_moore_penrose(x_e, y_e,
                                              batch_size=batch_size)
        gram_f, ord_f = batched_moore_penrose(x_f, y_f,
                                              batch_size=batch_size)
        return gram_e, gram_f, ord_e, ord_f

    def fit_from_file(self, filename: str, subset: Collection,
                      weight: float = 0.5, batch_size: int = 2500,
                      sample_weights: Dict = None,
                      energy_key: str = "energy",
                      progress=None,
                      drop_columns: List[str] = None):
        """Accumulate gram/ordinate over HDF5 feature chunks, then solve."""
        from uf3_tpu.representation import process
        if not os.path.isfile(filename):
            raise FileNotFoundError(filename)
        n_tables, _, table_names, _ = process.analyze_hdf_tables(filename)
        gram_e, gram_f, ord_e, ord_f = self.initialize_gram_ordinate()
        e_var = VarianceRecorder()
        f_var = VarianceRecorder()
        for table_name in table_names:
            df = process.load_feature_db(filename, table_name)
            keys = df.index.unique(level=0).intersection(subset)
            if len(keys) == 0:
                continue
            if drop_columns is not None:
                df = df.drop(columns=drop_columns)
            g_e, g_f, o_e, o_f = self.gram_from_df(
                df, keys, e_variance=e_var, f_variance=f_var,
                sample_weights=sample_weights, energy_key=energy_key,
                batch_size=batch_size)
            gram_e += g_e
            gram_f += g_f
            ord_e += o_e
            ord_f += o_f
        energy_weight, force_weight = calc_E_F_weights(
            e_var.n, f_var.n, e_var.std, f_var.std)
        gram, ordinate = self.combine_weighted_gram(
            gram_e, gram_f, ord_e, ord_f, energy_weight, force_weight,
            weight)
        self.fit_with_gram(gram, ordinate)

    def batched_predict(self, filename: str, keys=None, table_names=None,
                        score: bool = True, drop_columns=None):
        n_elements = len(self.bspline_config.element_list)
        y_e, p_e, y_f, p_f = batched_prediction(
            self, filename, table_names=table_names, subset_keys=keys,
            n_elements=n_elements, drop_columns=drop_columns)
        if not score:
            return y_e, p_e, y_f, p_f
        rmse_e, rmse_f = rmse_metric(y_e, p_e), rmse_metric(y_f, p_f)
        print(f"RMSE (energy): {rmse_e:.3F}\nRMSE (forces): {rmse_f:.3F}")
        return y_e, p_e, y_f, p_f, rmse_e, rmse_f

    # -- serialization ------------------------------------------------------
    @staticmethod
    def from_config(config):
        return WeightedLinearModel.from_dict(config)

    @staticmethod
    def from_dict(config: Dict) -> "WeightedLinearModel":
        bspline_config = BSplineBasis.from_dict(config)
        model = WeightedLinearModel(
            bspline_config,
            regularizer=config.get("regularizer"),
            data_coverage=config.get("data_coverage"))
        model.load(solution=config)
        return model

    @staticmethod
    def from_json(filename: str) -> "WeightedLinearModel":
        return WeightedLinearModel.from_dict(
            json_io.load_interaction_map(filename))

    def as_dict(self) -> Dict:
        solution = arrange_coefficients(self.coefficients,
                                        self.bspline_config)
        for trio in self.bspline_config.interactions_map.get(3, []):
            solution[trio] = self.bspline_config.decompress_3B(
                solution[trio], trio)
        return dict(coefficients=solution,
                    knots=self.bspline_config.knots_map,
                    data_coverage=self.data_coverage,
                    **self.bspline_config.as_dict())

    def to_json(self, filename: str):
        json_io.dump_interaction_map(self.as_dict(), filename=filename,
                                     write=True)

    def load(self, solution: Dict = None, filename: str = None):
        """Arrange per-interaction coefficient vectors (3B possibly as a
        full L x M x N grid) into the flat coefficient vector."""
        if filename is not None:
            solution = json_io.load_interaction_map(filename)
        elif solution is None:
            raise ValueError("Neither solution nor filename provided.")
        for nesting in ("coefficients", "solution"):
            if nesting in solution:
                solution = solution[nesting]
                break
        # Canonicalize interaction keys to electronegativity order.
        solution = {
            composition.sort_interaction_symbols(k)
            if isinstance(k, tuple) else k: v
            for k, v in dict(solution).items()}
        cfg = self.bspline_config
        component_len = cfg.get_interaction_partitions()[0]

        def checked(key, vec):
            if len(vec) != component_len[key]:
                raise ValueError(
                    f"Incorrect shape: {key}, "
                    f"{len(vec)} != {component_len[key]}")
            return vec

        segments = [np.atleast_1d(solution[el]) for el in cfg.element_list]
        for pair in cfg.interactions_map[2]:
            if pair not in solution:
                warnings.warn(f"{pair} not provided.")
                solution[pair] = np.zeros(component_len[pair])
            segments.append(checked(pair, solution[pair]))
        for trio in cfg.interactions_map.get(3, []):
            if trio not in solution:
                warnings.warn(f"{trio} not provided.")
                continue
            grid = np.array(solution[trio])
            if grid.ndim > 1:  # full LxMxN grid -> symmetry-compressed
                grid = cfg.compress_3B(grid, trio, fitting=False)
            segments.append(checked(trio, grid))
        flattened = np.concatenate(segments)
        n_coefficients = sum(cfg.partition_sizes)
        if len(flattened) != n_coefficients:
            raise ValueError(f"Incorrect coefficients: {len(flattened)} "
                             f"provided, {n_coefficients} expected.")
        self.coefficients = flattened

    def dump(self):
        return self.as_dict()

    # -- post-processing ----------------------------------------------------
    def fix_repulsion_2b(self, pair, r_target=None, min_curvature=2.0):
        """Replace poorly-covered low-r coefficients with a repulsive
        Taylor extrapolation of the fitted spline."""
        sizes, offsets = self.bspline_config.get_interaction_partitions()
        offset, n_basis = offsets[pair], sizes[pair]
        rows = slice(offset, offset + n_basis)
        c_subset = self.coefficients[rows]
        first_covered = int(np.argmax(self.data_coverage[rows]))
        if first_covered == 0:
            print(f"Coverage is sufficient; no fix applied to {pair}.")
        idx_fix = np.arange(self.bspline_config.leading_trim[2],
                            first_covered)
        knot_sequence = self.bspline_config.knots_map[pair]
        r_centers = knot_sequence[2:n_basis + 2]
        c_new = get_spline_taylor_expansion(
            r_centers[first_covered] if r_target is None else r_target,
            r_centers[idx_fix], c_subset, knot_sequence,
            min_curvature=min_curvature)
        print(f"{pair} Correction: adjusted {len(idx_fix)} coefficients.")
        self.coefficients[offset + idx_fix] = c_new


def get_spline_taylor_expansion(r_target, r, coefficients, knot_sequence,
                                min_curvature=0.0):
    """Second-order Taylor extrapolation of a fitted 1D spline."""
    pt = np.atleast_1d(np.float64(r_target))
    y0 = sp.evaluate_spline(pt, knot_sequence, coefficients, nu=0)[0]
    d1 = sp.evaluate_spline(pt, knot_sequence, coefficients, nu=1)[0]
    d2 = sp.evaluate_spline(pt, knot_sequence, coefficients, nu=2)[0]
    if min_curvature is not None:
        d2 = max(d2, min_curvature)
    dr = np.asarray(r) - r_target
    return y0 + d1 * dr + 0.5 * d2 * dr ** 2


# ---------------------------------------------------------------------------
# prediction / metrics / arrangement
# ---------------------------------------------------------------------------
def subset_prediction(df: pd.DataFrame, model: WeightedLinearModel,
                      subset_keys=None, **kwargs):
    if subset_keys is not None:
        idx = df.index.unique(level=0).intersection(subset_keys)
        if len(idx) == 0:
            return [], [], [], []
        df = df.loc[idx]
    x_e, y_e, x_f, y_f = dataframe_to_tuples(df, **kwargs)
    return y_e, model.predict(x_e), y_f, model.predict(x_f)


def batched_prediction(model: WeightedLinearModel, filename: str,
                       table_names=None, subset_keys=None,
                       drop_columns=None, **kwargs):
    from uf3_tpu.representation import process
    if table_names is None:
        _, _, table_names, _ = process.analyze_hdf_tables(filename)
    y_e, p_e, y_f, p_f = [], [], [], []
    for df in process.dataframe_batch_loader(filename, table_names):
        if drop_columns is not None:
            df = df.drop(columns=drop_columns)
        predictions = subset_prediction(df, model,
                                        subset_keys=subset_keys, **kwargs)
        y_e.append(predictions[0])
        p_e.append(predictions[1])
        y_f.append(predictions[2])
        p_f.append(predictions[3])
    return (np.concatenate(y_e), np.concatenate(p_e),
            np.concatenate(y_f), np.concatenate(p_f))


def rmse_metric(predicted, actual) -> float:
    return np.sqrt(np.mean(np.subtract(predicted, actual) ** 2))


def mae_metric(predicted, actual) -> float:
    return np.mean(np.abs(np.subtract(predicted, actual)))


def arrange_coefficients(coefficients, bspline_config) -> Dict:
    """Split the flat coefficient vector into per-interaction entries."""
    split_indices = np.cumsum(bspline_config.partition_sizes)[:-1]
    pieces = np.array_split(coefficients, split_indices)
    element_list = bspline_config.element_list
    solutions = {el: piece[0]
                 for el, piece in zip(element_list, pieces)}
    pieces = pieces[len(element_list):]
    j = 0
    for degree in range(2, bspline_config.degree + 1):
        for interaction in bspline_config.interactions_map[degree]:
            solutions[interaction] = pieces[j]
            j += 1
    return solutions


def postprocess_coefficients_2b(coefficients,
                                core_hardness: float = 2.0,
                                min_core: float = 2.0,
                                min_slope: float = 0.1,
                                rounding_factor: int = 3,
                                smooth_cutoff: bool = False,
                                in_place: bool = False) -> np.ndarray:
    """Enforce a repulsive core (and optionally smooth cutoff) on fitted
    pair coefficients (reference least_squares.py:1075-1144)."""
    c = coefficients if in_place else np.array(coefficients)
    well_idx = find_pair_potential_well(c, rounding_factor)
    if well_idx > 1:
        # Tiny monotone tie-breaker so flat plateaus resolve rightward.
        tilt = np.arange(well_idx) * 10 ** (-2 * rounding_factor)
        head = np.round(c[:well_idx], rounding_factor) + tilt
        peak_idx = int(np.argmax(head))
        monotone = bool(np.all(np.gradient(head)[:peak_idx] >= 0))
        if monotone:
            # Geometric core: each knot >= hardness x its right neighbor,
            # floored at min_slope; sequential because each step reads
            # the value the previous one just wrote.
            for i in range(peak_idx - 1, -1, -1):
                c[i] = max(abs(c[i + 1]) * core_hardness, min_slope)
    c[0] = max(c[0], min_core)
    if smooth_cutoff:
        c[-2:] = 0
    return c


def find_pair_potential_well(coefficients, rounding_factor) -> int:
    """Index of the attractive minimum; if everything left of the peak is
    flat to rounding precision, place it just past the peak instead."""
    peak_idx, well_idx = np.argmax(coefficients), np.argmin(coefficients)
    flat_tol = 10 ** -(rounding_factor - 1)
    if (well_idx < peak_idx
            and np.ptp(np.round(coefficients[:peak_idx],
                                rounding_factor)) < flat_tol):
        well_idx = peak_idx + 1
    return well_idx
