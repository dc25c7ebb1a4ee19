"""
Two-phase tungsten melting-point trial on the GPU (BASELINE config 4;
reference supplement/melting_point/melting_uf.in): equilibrate a long
bcc box under NPT at the trial temperature, melt one half with the
other half pinned (effectively-infinite masses), re-cool the molten
half, release everything under NPT, and watch which phase grows via
an x-binned Bragg order profile.

The full protocol (staging, order parameter, verdicts, JSON artifact)
lives in benchmarks/melting_run.py; this example runs one trial
temperature with a reduced box by default.

Usage: python examples/melting_point.py [trial_T_kelvin] [obs_steps]
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

from melting_run import run_trial  # noqa: E402
from uf3_tpu.regression.least_squares import WeightedLinearModel  # noqa: E402


def main():
    trial_t = float(sys.argv[1]) if len(sys.argv) > 1 else 3000.0
    n_obs = int(sys.argv[2]) if len(sys.argv) > 2 else 8000
    model = WeightedLinearModel.from_json(
        os.path.join(REPO, "benchmarks_data", "model_2and3.json"))
    log = run_trial(model, trial_t, reps=(32, 12, 12), n_obs=n_obs)
    print(f"T = {trial_t:.0f} K, {log['n_atoms']} atoms: "
          f"verdict = {log['verdict']}")
    if "solid_fraction_series" in log:
        print("solid fraction over the release stage:",
              log["solid_fraction_series"])
        print("(grew -> T below melting; shrank -> T above)")


if __name__ == "__main__":
    main()
