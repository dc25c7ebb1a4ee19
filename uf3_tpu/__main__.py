"""
Command-line interface: the YAML-driven pipeline the reference documents
but ships only as notebooks (readme.rst:57-58 marks its CLI as WIP).

    python -m uf3_tpu featurize settings.yaml   parse + featurize -> HDF5
    python -m uf3_tpu fit settings.yaml         fit -> model JSON
    python -m uf3_tpu predict settings.yaml     holdout RMSE report
    python -m uf3_tpu md model.json [options]   quick MD run
    python -m uf3_tpu export model.json         LAMMPS .uf3 potential
"""

import argparse
import os
import sys

import numpy as np


def cmd_featurize(settings_path: str) -> None:
    from uf3_tpu.data import io
    from uf3_tpu.util import user_config
    settings = user_config.read_config(settings_path)
    handlers = user_config.generate_handlers(settings)
    coordinator = handlers.get("data") or io.DataCoordinator()
    sources = settings["data"]["sources"]
    paths = io.identify_paths(experiment_path=sources.get("path", "."),
                              filename_pattern=sources.get("pattern"))
    io.parse_with_subsampling(
        paths, coordinator,
        max_samples=settings["data"].get("max_per_file", -1),
        min_diff=settings["data"].get("min_diff", 0.0),
        vasp_pressure=settings["data"].get("vasp_pressure", False))
    df_data = coordinator.consolidate()
    print(f"{len(df_data)} configurations")
    featurizer = handlers["features"]
    features_path = settings["features"]["features_path"]
    n_cores = settings["features"].get("n_cores", 1)
    if n_cores > 1:
        from uf3_tpu.util import parallel as par
        with par.get_executor(n_cores) as executor:
            featurizer.batched_to_hdf(features_path, df_data,
                                      client=executor, n_jobs=n_cores)
    else:
        featurizer.batched_to_hdf(features_path, df_data)
    print(f"features written to {features_path}")


def cmd_fit(settings_path: str) -> None:
    from uf3_tpu.representation import process
    from uf3_tpu.util import user_config
    settings = user_config.read_config(settings_path)
    handlers = user_config.generate_handlers(settings)
    model = handlers["learning"]
    features_path = settings["learning"]["features_path"]
    _, _, table_names, _ = process.analyze_hdf_tables(features_path)
    keys = set()
    for name in table_names:
        df = process.load_feature_db(features_path, name)
        keys.update(df.index.get_level_values(0))
    model.fit_from_file(features_path, subset=sorted(keys),
                        weight=settings["learning"].get("weight", 0.5))
    model_path = settings["model"]["model_path"]
    model.to_json(model_path)
    print(f"model written to {model_path}")


def cmd_predict(settings_path: str) -> None:
    from uf3_tpu.regression import least_squares as ls
    from uf3_tpu.util import user_config
    settings = user_config.read_config(settings_path)
    handlers = user_config.generate_handlers(settings)
    model = handlers.get("model")
    if model is None:
        model = ls.WeightedLinearModel.from_json(
            settings["model"]["model_path"])
    model.batched_predict(settings["learning"]["features_path"])


def cmd_md(model_path: str, args) -> None:
    import jax.numpy as jnp
    from uf3_tpu.data.atoms import bulk
    from uf3_tpu.forcefield.md import MDSystem
    from uf3_tpu.regression import least_squares as ls
    from uf3_tpu.util.runtime import enable_compile_cache
    enable_compile_cache()
    model = ls.WeightedLinearModel.from_json(model_path)
    element = model.bspline_config.element_list[0]
    atoms = bulk(element, "bcc", a=args.lattice) * args.reps
    print(f"{len(atoms)} atoms of {element}")
    system = MDSystem(model, atoms, dtype=jnp.float32,
                      n_respa=args.respa, respa_mid=args.respa_mid,
                      static_rebuild=args.static_rebuild)
    state = system.init_state(temperature=args.temperature)
    callback = None
    if args.traj:
        from uf3_tpu.forcefield.batch import TrajectoryWriter
        callback = TrajectoryWriter(args.traj, system)
    import time
    t0 = time.time()
    state = system.run(state, n_steps=args.steps, dt_fs=args.dt,
                       thermostat="langevin",
                       temperature=args.temperature,
                       callback=callback)
    elapsed = time.time() - t0
    print(f"{args.steps} steps in {elapsed:.2f} s "
          f"({len(atoms) * args.steps / elapsed:.3e} atom-steps/s); "
          f"T = {system.temperature(state):.0f} K, "
          f"E = {float(state.energy):.3f} eV")


def cmd_export(model_path: str, out_dir: str) -> None:
    from uf3_tpu.forcefield import lammps
    from uf3_tpu.regression import least_squares as ls
    model = ls.WeightedLinearModel.from_json(model_path)
    path = lammps.write_uf3_lammps_pot_files(model=model,
                                             pot_dir=out_dir)
    print(f"potential written to {path}")
    print(lammps.generate_lammps_input(model, path))


def main() -> None:
    parser = argparse.ArgumentParser(prog="uf3_tpu")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("featurize", "fit", "predict"):
        p = sub.add_parser(name)
        p.add_argument("settings")
    p_md = sub.add_parser("md")
    p_md.add_argument("model")
    p_md.add_argument("--reps", type=int, default=10)
    p_md.add_argument("--lattice", type=float, default=3.1652)
    p_md.add_argument("--steps", type=int, default=1000)
    p_md.add_argument("--dt", type=float, default=2.0)
    p_md.add_argument("--temperature", type=float, default=300.0)
    p_md.add_argument("--respa", type=int, default=1,
                      help="r-RESPA inner steps per outer step "
                           "(1 = plain velocity Verlet)")
    p_md.add_argument("--respa-mid", type=int, default=1,
                      help="3-level r-RESPA: inner steps per mid "
                           "(3-body force) step; must divide --respa")
    p_md.add_argument("--static-rebuild", action="store_true",
                      help="unconditional full neighbor rebuild every "
                           "cycle (no adaptive trigger/switch)")
    p_md.add_argument("--traj", default=None,
                      help="write an extended-xyz trajectory (one "
                           "frame per chunk) to this path")
    p_export = sub.add_parser("export")
    p_export.add_argument("model")
    p_export.add_argument("--out", default=".")
    args = parser.parse_args()
    if args.command == "featurize":
        cmd_featurize(args.settings)
    elif args.command == "fit":
        cmd_fit(args.settings)
    elif args.command == "predict":
        cmd_predict(args.settings)
    elif args.command == "md":
        cmd_md(args.model, args)
    elif args.command == "export":
        cmd_export(args.model, args.out)


if __name__ == "__main__":
    main()
