"""Generate the published results gallery (VERDICT r3 missing #1).

Runs all 4 scenarios x 2 presets through the CLI pipeline on the
attached accelerator and writes the reference's artifact tree:

    results/Custom_Scenarios/{scenario}_results.png
    results/Custom_Scenarios/{scenario}_dr_cvar_halfspaces.png
    results/Custom_Scenarios/{scenario}_dr_cvar_animation.gif
    results/Paper_Scenarios/...   (same names)

mirroring /root/reference/results/ (reference README.md:163-199).
Animations go through main.py's ffmpeg -> pillow fallback, which lands
on .gif in this environment -- the reference's published format.

Run:  python experiments/make_gallery.py [--skip_animate]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import main as cli  # noqa: E402

SCENARIOS = ("head_on", "overtaking", "intersection", "multi_obstacle")
PRESETS = (("custom", "Custom_Scenarios"), ("paper", "Paper_Scenarios"))


def run(skip_animate: bool = False):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for preset, subdir in PRESETS:
        save_dir = os.path.join(repo, "results", subdir)
        for scenario in SCENARIOS:
            t0 = time.time()
            argv = ["--scenario", scenario, "--preset", preset,
                    "--mode", "single", "--save_dir", save_dir]
            if not skip_animate:
                argv.append("--animate")
            print(f"=== {preset}/{scenario} ===", flush=True)
            cli.main(argv)
            print(f"=== {preset}/{scenario} done in "
                  f"{time.time() - t0:.1f}s ===", flush=True)


if __name__ == "__main__":
    run(skip_animate="--skip_animate" in sys.argv)
