"""
Device-mesh parallelism (jax.sharding + shard_map).

UF3's training collective needs are small -- one (n_feat, n_feat) Gram
reduction -- so a 1-D data-parallel mesh covers everything the
reference's dask/futures task pool did (uf3/util/parallel.py:13-18) and
runs it over the device interconnect instead of process pools:

  * batch-sharded Gram/ordinate accumulation: per-shard X^T X followed
    by a psum across the mesh;
  * replicated MD state with sharded neighbor/force computation for
    multi-chip MD (atom-sharded rows; neighbor gathers stay local
    because every device holds the replicated positions).
"""

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    devices = np.array(jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def _pad_rows(array, multiple):
    n = array.shape[0]
    pad = (-n) % multiple
    if pad:
        array = np.concatenate(
            [array, np.zeros((pad,) + array.shape[1:], array.dtype)])
    return array


def sharded_gram(x: np.ndarray,
                 y: np.ndarray,
                 mesh: Mesh,
                 axis_name: str = "data"
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """
    Gram matrix (X^T X) and ordinate (X^T y) with rows sharded across
    the mesh; the reduction rides the mesh axis (psum).
    Zero-padded rows contribute nothing.
    """
    n_shards = mesh.shape[axis_name]
    x = _pad_rows(np.asarray(x), n_shards)
    y = _pad_rows(np.asarray(y), n_shards)
    x_sharded = jax.device_put(
        x, NamedSharding(mesh, P(axis_name, None)))
    y_sharded = jax.device_put(y, NamedSharding(mesh, P(axis_name)))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis_name, None), P(axis_name)),
             out_specs=(P(), P()))
    def accumulate(x_shard, y_shard):
        gram = jax.lax.psum(x_shard.T @ x_shard, axis_name)
        ordinate = jax.lax.psum(x_shard.T @ y_shard, axis_name)
        return gram, ordinate

    return accumulate(x_sharded, y_sharded)


def fit_sharded(model,
                x_e: np.ndarray,
                y_e: np.ndarray,
                x_f: np.ndarray = None,
                y_f: np.ndarray = None,
                weight: float = 0.5,
                mesh: Mesh = None) -> None:
    """
    Mesh-parallel twin of WeightedLinearModel.fit: frozen-column
    elimination on host, Gram accumulation sharded over devices,
    energy/force weighting and the (small) solve on host in float64.
    """
    from uf3_tpu.regression import least_squares as ls
    if mesh is None:
        mesh = make_mesh()
    x_e, y_e = ls.freeze_columns(x_e, y_e, model.mask, model.frozen_c,
                                 model.col_idx)
    gram_e, ord_e = sharded_gram(x_e, y_e, mesh)
    gram_e = np.asarray(gram_e, dtype=np.float64)
    ord_e = np.asarray(ord_e, dtype=np.float64)
    if x_f is not None:
        energy_weight, force_weight = ls.calc_E_F_weights(
            len(y_e), len(y_f), np.std(y_e), np.std(y_f))
        x_f, y_f = ls.freeze_columns(x_f, y_f, model.mask,
                                     model.frozen_c, model.col_idx)
        gram_f, ord_f = sharded_gram(x_f, y_f, mesh)
        gram, ordinate = model.combine_weighted_gram(
            gram_e, np.asarray(gram_f, dtype=np.float64),
            ord_e, np.asarray(ord_f, dtype=np.float64),
            energy_weight, force_weight, weight)
    else:
        gram, ordinate = gram_e, ord_e
    model.fit_with_gram(gram, ordinate)


def fit_from_file_sharded(model,
                          filename: str,
                          subset,
                          weight: float = 0.5,
                          mesh: Mesh = None,
                          sample_weights: dict = None,
                          energy_key: str = "energy",
                          drop_columns=None) -> None:
    """
    Mesh-parallel twin of WeightedLinearModel.fit_from_file
    (regression/least_squares.py:350): stream HDF5 feature chunks on
    the host, accumulate each chunk's Gram/ordinate on the device mesh
    (rows sharded, psum over the mesh), track energy/force variances with
    streaming VarianceRecorders, and solve on host in float64.  Full
    parity surface: per-sample weights, custom energy key, column
    drops.
    """
    import os as _os

    from uf3_tpu.regression import least_squares as ls
    from uf3_tpu.representation import process

    if mesh is None:
        mesh = make_mesh()
    if not _os.path.isfile(filename):
        raise FileNotFoundError(filename)
    n_elements = len(model.bspline_config.element_list)
    _, _, table_names, _ = process.analyze_hdf_tables(filename)
    gram_e, gram_f, ord_e, ord_f = model.initialize_gram_ordinate()
    e_var = ls.VarianceRecorder()
    f_var = ls.VarianceRecorder()
    for table_name in table_names:
        df = process.load_feature_db(filename, table_name)
        keys = df.index.unique(level=0).intersection(subset)
        if len(keys) == 0:
            continue
        if drop_columns is not None:
            df = df.drop(columns=drop_columns)
        x_e, y_e, x_f, y_f = ls.dataframe_to_tuples(
            df.loc[keys], n_elements=n_elements,
            energy_key=energy_key, sample_weights=sample_weights)
        x_e, y_e = ls.freeze_columns(x_e, y_e, model.mask,
                                     model.frozen_c, model.col_idx)
        x_f, y_f = ls.freeze_columns(x_f, y_f, model.mask,
                                     model.frozen_c, model.col_idx)
        e_var.update(y_e)
        f_var.update(y_f)
        g_e, o_e = sharded_gram(x_e, y_e, mesh)
        g_f, o_f = sharded_gram(x_f, y_f, mesh)
        gram_e += np.asarray(g_e, dtype=np.float64)
        gram_f += np.asarray(g_f, dtype=np.float64)
        ord_e += np.asarray(o_e, dtype=np.float64)
        ord_f += np.asarray(o_f, dtype=np.float64)
    energy_weight, force_weight = ls.calc_E_F_weights(
        e_var.n, f_var.n, e_var.std, f_var.std)
    gram, ordinate = model.combine_weighted_gram(
        gram_e, gram_f, ord_e, ord_f, energy_weight, force_weight,
        weight)
    model.fit_with_gram(gram, ordinate)


def sharded_md_step_factory(system, mesh: Mesh, axis_name: str = "data",
                            n_steps: int = 1):
    """
    Multi-chip MD: positions replicated, per-atom neighbor rows (and
    hence force rows) sharded across the mesh.  Each device runs the
    fused force kernels for its atom shard -- the displacement gathers
    read the replicated position array locally, and GSPMD inserts the
    collectives for the cross-shard reverse-slot exchange and the
    position all-gather at the integration step.

    Returns (chunk, shard_atoms): ``chunk(positions, velocities,
    forces, nbr2, nbr3, dt)`` advances ``n_steps`` of velocity-Verlet
    NVE (identical math to the single-chip inner scan) and returns
    (positions, velocities, forces, energy).
    """
    n_shards = mesh.shape[axis_name]
    m = system.masses[:, None]

    def chunk(positions, velocities, forces, nbr2, nbr3, dt):
        def step(carry, _):
            x, v, f = carry
            v = v + 0.5 * dt * f / m
            x = x + dt * v
            _, f, _ = system.energy_forces(x, nbr2, nbr3,
                                           with_energy=False)
            v = v + 0.5 * dt * f / m
            return (x, v, f), None
        (x, v, f), _ = jax.lax.scan(step, (positions, velocities,
                                           forces), None,
                                    length=n_steps)
        energy, f, _ = system.energy_forces(x, nbr2, nbr3)
        return x, v, f, energy

    # shard the per-atom axis of the neighbor lists and let jit/GSPMD
    # insert the collectives
    def shard_atoms(tree):
        def spec_for(leaf):
            if leaf.ndim >= 1 and leaf.shape[0] % n_shards == 0:
                return NamedSharding(mesh, P(axis_name))
            return NamedSharding(mesh, P())
        return jax.tree.map(
            lambda leaf: jax.device_put(leaf, spec_for(leaf)), tree)

    return jax.jit(chunk), shard_atoms
