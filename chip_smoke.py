"""
Smoke test of the GPU build: drives the MD and fit paths once, through
the public entry points, at the headline width, and checks each
against the host f64 references.

    python3 chip_smoke.py           # one GPU
    python3 chip_smoke.py --four    # four GPUs: sharded fit and
                                    # halo-exchange MD, nothing else

Phases on one GPU, in one process: device check; NVT MD of the
2+3-body W potential on the 9,826-atom bcc cell at the bench r-RESPA
cadence; f32 forces against the f64 host calculator at that size; NVE
drift; device featurization + fit of 256 generated cells against the
host featurizer; the `gpu`-marked tests.  Rates printed on the way are
smoke readings, not benchmarks.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  Otherwise the last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from uf3_tpu.data.atoms import bulk, rattled_bcc_dataset
from uf3_tpu.data.composition import ChemicalSystem
from uf3_tpu.forcefield.calculator import UFCalculator
from uf3_tpu.forcefield.md import MDSystem
from uf3_tpu.ops import pallas_trio as pt
from uf3_tpu.ops.featurize_jax import featurize_dataset_device
from uf3_tpu.regression.least_squares import WeightedLinearModel
from uf3_tpu.representation.basis import BSplineBasis
from uf3_tpu.representation.process import BasisFeaturizer
from uf3_tpu.util.runtime import enable_compile_cache, require_gpu

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(REPO, "benchmarks_data", "model_2and3.json")
LATTICE = 3.1652            # bcc W, A
BENCH_REPS = 17             # 17^3 bcc cell = 9,826 atoms (bench.py)
# bench.py's MD configuration: two-tier skins, 3-level r-RESPA 12/6/36
BENCH_MD = dict(rebuild_every=36, skin=0.5, skin_2b=1.2, capacity_2b=72,
                capacity_3b=16, n_respa=12, respa_mid=6,
                respa_switch=(2.5, 3.5))
NVE_TOL = 2e-4              # eV/atom over 216 steps (docs/md_engine.md)
FEATURE_RTOL = 1e-9         # of the largest feature magnitude


class PhaseError(RuntimeError):
    """A smoke check that did not hold."""


def check(ok: bool, message: str):
    if not ok:
        raise PhaseError(message)


def card_label() -> str:
    """Card names and power limits from nvidia-smi (a child process
    that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def make_logger(label: str):
    def log(message: str):
        print(f"[{label}] {message}", flush=True)
    return log


def fit_basis() -> BSplineBasis:
    """The fit benchmark's W basis (benchmarks/fit_wallclock.py)."""
    return BSplineBasis(
        ChemicalSystem(["W"], degree=3),
        r_min_map={("W", "W"): 1.5, ("W", "W", "W"): [1.5, 1.5, 1.5]},
        r_max_map={("W", "W"): 5.5, ("W", "W", "W"): [3.5, 3.5, 7.0]},
        resolution_map={("W", "W"): 25, ("W", "W", "W"): [6, 6, 12]})


def _bytes(n) -> str:
    return f"{n / 2 ** 20:.1f} MiB"


def md_phase(model, reps: int, log, warm_steps: int = 144,
             steps: int = 720, launch_chunks: int = 10):
    """Langevin NVT at 300 K through MDSystem.init_state/run at the
    bench cadence; returns (system, state) for the NVE phase."""
    geom = bulk("W", "bcc", a=LATTICE) * (reps, reps, reps)
    n_atoms = len(geom)
    system = MDSystem(model, geom, dtype=jnp.float32, **BENCH_MD)
    nvt = dict(dt_fs=2.0, thermostat="langevin", temperature=300.0,
               tau_fs=100.0, friction_ps=2.0)
    t0 = time.perf_counter()
    state = system.init_state(temperature=300.0, seed=0)
    state = system.run(state, n_steps=warm_steps, **nvt)
    jax.block_until_ready(state.positions)
    log(f"md: {n_atoms} atoms, init + {warm_steps} warm-up steps "
        f"(compiles included) {time.perf_counter() - t0:.1f} s")
    check(not system.overflowed(state), "md: neighbor list overflow "
          "during warm-up")
    # the window's launch, compiled ahead of time (with the arguments
    # run() passes) to read its compile time and buffer sizes; run()
    # then finds it in the compilation cache
    n_outer = system.rebuild_every // system.n_respa
    t0 = time.perf_counter()
    compiled = MDSystem._run_chunk_respa.lower(
        system, state, n_outer=n_outer, compute_energy=True,
        n_chunks=launch_chunks, **nvt).compile()
    log(f"md: compile of one {launch_chunks}-cycle launch "
        f"{time.perf_counter() - t0:.1f} s")
    mem = compiled.memory_analysis()
    if mem is not None:
        log("md: launch memory_analysis: "
            f"arguments {_bytes(mem.argument_size_in_bytes)}, "
            f"outputs {_bytes(mem.output_size_in_bytes)}, "
            f"aliased {_bytes(mem.alias_size_in_bytes)}, "
            f"temporaries {_bytes(mem.temp_size_in_bytes)}, "
            f"code {_bytes(mem.generated_code_size_in_bytes)}")
    # each run() call is one launch, so every launch of the window is
    # the executable compiled above
    launch_steps = system.rebuild_every * launch_chunks
    if steps % launch_steps:
        raise ValueError(f"steps={steps} is not a whole number of "
                         f"{launch_steps}-step launches")
    stale = jnp.zeros((), dtype=bool)

    def window():
        nonlocal state, stale
        t0 = time.perf_counter()
        for _ in range(steps // launch_steps):
            state = system.run(state, n_steps=launch_steps,
                               launch_chunks=launch_chunks, sync=False,
                               **nvt)
            stale = stale | state.stale
        jax.block_until_ready(state.positions)
        return time.perf_counter() - t0

    t_first = window()
    elapsed = window()
    check(not system.overflowed(state), "md: neighbor list overflow")
    energy = float(state.energy)
    check(np.isfinite(energy), f"md: energy {energy}")
    check(bool(np.all(np.isfinite(np.asarray(state.positions)))),
          "md: non-finite positions")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    log(f"md: first {steps} steps (launch_chunks={launch_chunks}) "
        f"{t_first:.2f} s; second {steps} steps {elapsed:.3f} s = "
        f"{n_atoms * steps / elapsed:.4e} atom-steps/s (smoke reading, "
        f"not a benchmark); T = {system.temperature(state):.0f} K, "
        f"E = {energy / n_atoms:.5f} eV/atom, stale = "
        f"{bool(stale)}, peak_bytes_in_use = "
        f"{_bytes(peak) if peak is not None else 'n/a'}")
    return system, state


def nve_phase(system, state, log, steps: int = 216):
    """NVE continuation of the MD state at the same cadence; checks
    the drift criterion."""
    n_atoms = state.positions.shape[0]
    e0 = float(state.energy) + system.kinetic_energy(state)
    state = system.run(state, n_steps=steps, dt_fs=2.0)
    check(not system.overflowed(state), "nve: neighbor list overflow")
    e1 = float(state.energy) + system.kinetic_energy(state)
    drift = abs(e1 - e0) / n_atoms
    log(f"nve: {steps} steps, |dE|/atom = {drift:.3e} eV "
        f"(limit {NVE_TOL:g})")
    check(drift <= NVE_TOL, f"nve: drift {drift:.3e} eV/atom")
    return drift


def forces_phase(model, reps: int, log):
    """f32 MDSystem.energy_forces on a rattled cell against the host
    f64 UFCalculator."""
    geom = bulk("W", "bcc", a=LATTICE) * (reps, reps, reps)
    geom.rattle(0.05, seed=3)
    system = MDSystem(model, geom, dtype=jnp.float32, **BENCH_MD)
    state = system.init_state()
    t0 = time.perf_counter()
    f_ref = np.asarray(UFCalculator(model).get_forces(geom))
    log(f"forces: host f64 oracle on {len(geom)} atoms "
        f"{time.perf_counter() - t0:.1f} s, max |F| "
        f"{np.max(np.abs(f_ref)):.3f} eV/A")
    check(np.max(np.abs(f_ref)) > 0.1, "forces: degenerate reference")
    f = jax.jit(lambda x, n2, n3: system.energy_forces(x, n2, n3)[1])(
        state.positions, state.nbr2, state.nbr3)
    err = np.abs(np.asarray(f).astype(np.float64) - f_ref)
    err_max = float(err.max())
    log(f"forces: f32 vs f64 oracle with MATMUL_PRECISION="
        f"{pt.MATMUL_PRECISION!r}: max |dF| {err_max:.3e}, rms "
        f"{float(np.sqrt(np.mean(err ** 2))):.3e} eV/A (limit "
        f"{pt.F32_FORCE_TOL:g})")
    check(err_max <= pt.F32_FORCE_TOL,
          f"forces: max |dF| {err_max:.3e} eV/A")
    return err_max


def featurize_and_fit(n_configs: int, log):
    """Device features of the generated set and the one-device fit;
    returns (basis, dataset, features, model)."""
    basis = fit_basis()
    dataset = rattled_bcc_dataset(n_configs)
    t0 = time.perf_counter()
    featurize_dataset_device(basis, *dataset)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    features = featurize_dataset_device(basis, *dataset)
    t_feat = time.perf_counter() - t0
    model = WeightedLinearModel(basis, c2=1e-8, c3=1e-8)
    t0 = time.perf_counter()
    model.fit(*features, weight=0.5)
    t_solve = time.perf_counter() - t0
    log(f"fit: {n_configs} configs, featurize first pass (compiles "
        f"included) {t_first:.2f} s, second pass {t_feat:.3f} s = "
        f"{t_feat / n_configs * 1e3:.3f} ms/config; solve "
        f"{t_solve:.3f} s; total {(t_feat + t_solve) / n_configs:.3e} "
        f"s/config (smoke reading)")
    check(bool(np.all(np.isfinite(model.coefficients))),
          "fit: non-finite coefficients")
    return basis, dataset, features, model


def fit_phase(n_configs: int, n_compare: int, log):
    """Float64 device featurization + fit; the first ``n_compare``
    configs' feature rows are checked against the host featurizer."""
    jax.config.update("jax_enable_x64", True)
    basis, (geoms, energies, forces), (x_e, _, x_f, _), model = \
        featurize_and_fit(n_configs, log)
    featurizer = BasisFeaturizer(basis)
    row0 = 0
    worst = scale = 0.0
    for i in range(n_compare):
        n = len(geoms[i])
        ref = featurizer.evaluate_configuration(
            geoms[i], energy=energies[i], forces=forces[i])
        xe_ref = np.asarray(ref["energy"])[1:] / n
        xf_ref = np.stack([np.asarray(ref[f"f{c}_{a}"])[1:]
                           for c in "xyz" for a in range(n)])
        xf_dev = x_f[row0:row0 + 3 * n]
        row0 += 3 * n
        worst = max(worst, np.max(np.abs(x_e[i] - xe_ref)),
                    np.max(np.abs(xf_dev - xf_ref)))
        scale = max(scale, np.max(np.abs(xe_ref)),
                    np.max(np.abs(xf_ref)))
    log(f"fit: device vs host features on {n_compare} configs: max "
        f"|d| {worst:.3e} = {worst / scale:.3e} of the largest feature "
        f"(limit {FEATURE_RTOL:g})")
    check(worst <= FEATURE_RTOL * scale, "fit: feature mismatch")
    return model


class _Tally:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def gpu_tests_phase(log):
    """The `gpu`-marked tests, in this process (no second process may
    open the card)."""
    import pytest
    os.environ["UF3_GPU_TESTS"] = "1"
    jax.config.update("jax_enable_x64", False)
    tally = _Tally()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        rc = pytest.main(
            [os.path.join(REPO, "tests", "test_gpu_numerics.py"), "-m",
             "gpu", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
             "-p", "no:randomly"], plugins=[tally])
    for line in report.getvalue().splitlines():
        if line.strip():
            log(f"gpu tests | {line}")
    log(f"gpu tests: {tally.counts} (pytest exit {int(rc)})")
    check(int(rc) == 0 and tally.counts["passed"] > 0
          and not tally.counts["failed"] and not tally.counts["skipped"],
          "gpu tests failed or skipped")


def four_phase(model, log, n_devices: int = 4, n_configs: int = 256):
    """Sharded fit and halo-exchange r-RESPA MD over ``n_devices``
    GPUs, each against its one-device counterpart."""
    from uf3_tpu.forcefield import units
    from uf3_tpu.parallel import halo
    from uf3_tpu.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(n_devices)
    # halo MD (f32): slabs of 2 bcc repeats (6.33 A) against a 6.0 A
    # halo width; the 4x4 cross-section (12.7 A) keeps the minimum
    # image valid at the 5.5 A pair cutoff
    geom = bulk("W", "bcc", a=LATTICE) * (4, 4, 2 * n_devices)
    geom.rattle(0.03, seed=1)
    n = len(geom)
    system = MDSystem(model, geom, dtype=jnp.float32, capacity_2b=64,
                      capacity_3b=16)
    dec = halo.decompose(
        geom.get_positions(), geom.get_cell(), n_devices,
        r_cut_2b=system.r_cut_2b, r_cut_3b=system.r_cut_3b,
        skin=system.skin, capacity_2b=64, capacity_3b=16,
        masses=np.asarray(system.masses))
    x = jnp.asarray(halo.gather_positions(dec, dec.x_own, n),
                    dtype=jnp.float32)
    nbr2, nbr3 = system.build_lists(x, wrapped=True)
    e_ref, f_ref, _ = system.energy_forces(x, nbr2, nbr3)
    dt = jnp.asarray(2.0 * units.fs, dtype=jnp.float32)
    chunk0, shard = halo.halo_md_step_factory(
        system, mesh, n_steps=0, n_respa=3, respa_mid=3)
    v0 = shard(np.zeros(dec.x_own.shape))
    _, _, f_own, energy, stale = chunk0(shard(dec), shard(dec.x_own),
                                        v0, dt)
    f_halo = halo.gather_positions(dec, f_own, n)
    df = float(np.max(np.abs(f_halo - np.asarray(f_ref))))
    de = abs(float(energy) - float(e_ref)) / n
    log(f"four: halo r-RESPA forces on {n} atoms over {n_devices} "
        f"GPUs vs one GPU: max |dF| {df:.3e} eV/A, |dE|/atom "
        f"{de:.3e} eV, stale {bool(stale)}")
    check(df <= pt.F32_FORCE_TOL and de <= 1e-5 and not bool(stale),
          "four: halo forces/energy differ from one device")
    chunk6, _ = halo.halo_md_step_factory(
        system, mesh, n_steps=6, n_respa=3, respa_mid=3)
    args = (shard(dec), shard(dec.x_own), v0, dt)
    hlo = jax.jit(chunk6).lower(*args).compile().as_text()
    n_permute = hlo.count("collective-permute")
    log(f"four: halo chunk HLO: {n_permute} collective-permute, "
        f"{hlo.count('all-gather')} all-gather")
    check(n_permute > 0 and "all-gather" not in hlo,
          "four: halo chunk must exchange by ppermute only")
    _, _, _, energy6, stale6 = chunk6(*args)
    check(np.isfinite(float(energy6)) and not bool(stale6),
          "four: halo MD chunk")
    log(f"four: 6 halo r-RESPA steps, E = {float(energy6) / n:.5f} "
        f"eV/atom")
    # sharded Gram fit (f64) against the one-device fit
    jax.config.update("jax_enable_x64", True)
    basis, _, features, model_one = featurize_and_fit(n_configs, log)
    model_mesh = WeightedLinearModel(basis, c2=1e-8, c3=1e-8)
    t0 = time.perf_counter()
    pmesh.fit_sharded(model_mesh, *features, weight=0.5, mesh=mesh)
    t_mesh = time.perf_counter() - t0
    # the Gram sums run in another order, and weakly regularized
    # coefficients amplify that; the fitted predictions do not
    x_e, _, x_f, _ = features
    diff = max(np.max(np.abs(model_mesh.predict(x)
                             - model_one.predict(x))) for x in (x_e, x_f))
    scale = max(np.max(np.abs(model_one.predict(x))) for x in (x_e, x_f))
    dc = np.max(np.abs(model_mesh.coefficients - model_one.coefficients))
    log(f"four: fit_sharded over {n_devices} GPUs {t_mesh:.3f} s; "
        f"predictions max |d| {diff:.3e} of {scale:.3e}; coefficients "
        f"max |d| {dc:.3e}")
    check(diff <= 1e-8 * scale, "four: sharded fit differs")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    parser.add_argument("--four", action="store_true",
                        help="four-GPU sharded fit + halo MD only")
    args = parser.parse_args(argv)
    devices = require_gpu(4 if args.four else 1)
    label = card_label()
    print(f"card: {label}", flush=True)
    log = make_logger(label)
    cache_dir = enable_compile_cache()
    log(f"device: {devices[0].device_kind} x {len(devices)}, jax "
        f"{jax.__version__}, compile cache {cache_dir}")
    model = WeightedLinearModel.from_json(MODEL)
    t_start = time.perf_counter()
    try:
        if args.four:
            four_phase(model, log)
        else:
            system, state = md_phase(model, BENCH_REPS, log)
            forces_phase(model, BENCH_REPS, log)
            nve_phase(system, state, log)
            del system, state
            fit_phase(256, 4, log)
            gpu_tests_phase(log)
    except PhaseError as err:
        raise SystemExit(f"chip_smoke: FAILED: {err}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
