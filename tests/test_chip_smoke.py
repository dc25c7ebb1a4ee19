"""
CPU tests of the GPU smoke script and the process setup it shares with
the other entry points: the device check refuses a CPU backend, the
compile cache lands in a fixed directory, the MD and fit paths import
no optional package, the trace hook propagates profiler errors, and
the smoke phases pass their own comparisons at a tiny size.
"""

import glob
import os
import subprocess
import sys

import jax
import pytest

from uf3_tpu.regression import least_squares as ls
from uf3_tpu.util import runtime, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_python(args, cwd, **env):
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          env=full_env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("count", [1, 4])
def test_device_check_refuses_cpu(count):
    with pytest.raises(SystemExit) as info:
        chip_smoke.require_gpu(count)
    assert info.value.code not in (None, 0)


def test_script_fails_without_gpu(tmp_path):
    """On a CPU-only host the script exits non-zero and prints no
    result line."""
    proc = _run_python([os.path.join(REPO, "chip_smoke.py")],
                       cwd=tmp_path, PYTHONPATH=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, from_env):
    saved = jax.config.jax_compilation_cache_dir
    try:
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                               str(tmp_path))
            assert runtime.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself: nothing is set in code
            assert jax.config.jax_compilation_cache_dir == saved
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR",
                               raising=False)
            expected = os.path.join(REPO, ".jax_cache")
            assert runtime.REPO_CACHE_DIR == expected
            assert runtime.enable_compile_cache() == expected
            assert jax.config.jax_compilation_cache_dir == expected
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


BLOCKED_IMPORTS = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "h5py", "yaml"):
            raise ImportError(name + " is blocked")

sys.meta_path.insert(0, _Block())
import jax.numpy as jnp
import numpy as np
import chip_smoke as cs
from uf3_tpu.data.atoms import bulk, rattled_bcc_dataset
from uf3_tpu.forcefield.md import MDSystem
from uf3_tpu.ops.featurize_jax import featurize_dataset_device
from uf3_tpu.regression.least_squares import WeightedLinearModel

model = WeightedLinearModel.from_json(cs.MODEL)
geom = bulk("W", "bcc", a=cs.LATTICE) * (3, 3, 3)
system = MDSystem(model, geom, dtype=jnp.float32, **cs.BENCH_MD)
state = system.init_state(temperature=300.0, seed=0)
state = system.run(state, n_steps=36, dt_fs=2.0, thermostat="langevin",
                   temperature=300.0)
assert not system.overflowed(state)
assert np.isfinite(float(state.energy))
basis = cs.fit_basis()
features = featurize_dataset_device(basis, *rattled_bcc_dataset(2))
fitted = WeightedLinearModel(basis, c2=1e-8, c3=1e-8)
fitted.fit(*features, weight=0.5)
assert np.all(np.isfinite(fitted.coefficients))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("pandas", "h5py", "yaml"))
assert not loaded, loaded
print("OK")
"""


def test_md_and_fit_without_optional_packages():
    """With pandas, h5py and yaml unimportable, a saved model loads,
    MD runs at the bench r-RESPA cadence and a device fit runs."""
    proc = _run_python(["-c", BLOCKED_IMPORTS], cwd=REPO,
                       PYTHONPATH=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_trace_writes_profile(tmp_path):
    import jax.numpy as jnp
    with tracing.trace(str(tmp_path)):
        jnp.ones(8).block_until_ready()
    assert glob.glob(str(tmp_path / "plugins" / "profile" / "*"
                         / "*.xplane.pb"))


def test_trace_errors_propagate(tmp_path):
    with tracing.trace(str(tmp_path / "outer")):
        with pytest.raises(RuntimeError):
            # the profiler runs one trace at a time
            with tracing.trace(str(tmp_path / "inner")):
                pass


def test_trace_default_dir_is_in_checkout():
    assert tracing.TRACE_DIR == os.path.join(REPO, "chiprun_out",
                                             "trace")


@pytest.fixture(scope="module")
def model():
    return ls.WeightedLinearModel.from_json(chip_smoke.MODEL)


def _quiet(message):
    pass


def test_md_phase_tiny(model):
    system, state = chip_smoke.md_phase(model, 3, _quiet, warm_steps=36,
                                        steps=72, launch_chunks=2)
    assert state.positions.shape == (54, 3)
    assert not system.overflowed(state)


def test_forces_phase_tiny(model):
    err = chip_smoke.forces_phase(model, 3, _quiet)
    assert err <= chip_smoke.pt.F32_FORCE_TOL


def test_fit_phase_tiny():
    fitted = chip_smoke.fit_phase(4, 4, _quiet)
    assert fitted.coefficients is not None


def test_phase_checks_fail_loudly():
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.check(False, "deliberate")


SCRIPTS = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "benchmarks", "*.py"))
    + [os.path.join(REPO, "bench.py")])


@pytest.mark.parametrize("script", SCRIPTS)
def test_entry_scripts_import_cleanly(script):
    """Every measurement script imports without running anything (no
    interpreter re-exec, no device work outside main())."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_script_" + os.path.basename(script)[:-3],
        os.path.join(REPO, script))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.main)
