"""Compare one ``chip_smoke.py`` phase between two checkouts on one card,
in turns: A B B A A B, each turn a fresh process in that checkout.

    python3 -m fedml_tpu_torch.utils.phase_ab mqtt PARENT_DIR CHANGE_DIR

Each directory is the root of a checkout (for example the parent commit
unpacked with ``git archive`` beside the change's).  A turn loads the
phase's data, runs the phase and prints one JSON line ``{"tree": ...,
"rounds_per_s": ...}``; the last line holds the median of each tree.
Phases: ``mqtt`` (``check_silo_mqtt`` on the FEMNIST twin of the
defended slice, ``chip_smoke.SLICE_ARGS``: 3 rounds of the sharded
cross-silo slice over the repo's MQTT broker); ``bf16_lm`` (``run_lm_slice``
on bench.py's T=2048 flash LM under bf16: 3 graphed FedAvg rounds
through the bf16 K4 kernels, rounds/s of rounds 2-3).  Exits non-zero
without a GPU or when a turn fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# each phase's turn: it leaves a dict with "rounds_per_s" in ``out``
PHASES = {
    "mqtt": """
from fedml_tpu_torch.experiments.config import config_from_argv
from fedml_tpu_torch.experiments.main import load_experiment_data
data = load_experiment_data(config_from_argv(cs.SLICE_ARGS))
out = cs.check_silo_mqtt(data)""",
    "bf16_lm": """
import torch
from pathlib import Path
data = cs.lm_data()
out = cs.run_lm_slice(data, Path("."), names=cs.K4_BF16_NAMES,
                      algo=cs.lm_bf16_fedavg(data, dtype=torch.bfloat16),
                      label="transformer bf16")[2]""",
}
ORDER = (0, 1, 1, 0, 0, 1)

_TURN = '''
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
{body}
print("RESULT " + json.dumps({{"rounds_per_s": out["rounds_per_s"]}}))
'''


def main(argv=None) -> None:
    import torch
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 3 or args[0] not in PHASES:
        sys.exit(f"usage: phase_ab {{{'|'.join(PHASES)}}} A_DIR B_DIR")
    if not torch.cuda.is_available():
        sys.exit("phase_ab needs a GPU")
    trees = [Path(a).resolve() for a in args[1:]]
    code = _TURN.format(body=PHASES[args[0]])
    rates = {str(t): [] for t in trees}
    for i in ORDER:
        run = subprocess.run([sys.executable, "-c", code], cwd=trees[i],
                             capture_output=True, text=True, timeout=900)
        lines = [line for line in run.stdout.splitlines()
                 if line.startswith("RESULT ")]
        if run.returncode != 0 or not lines:
            sys.exit(f"turn in {trees[i]} failed ({run.returncode}): "
                     f"{run.stderr[-2000:]}")
        rate = json.loads(lines[-1][len("RESULT "):])["rounds_per_s"]
        rates[str(trees[i])].append(rate)
        print(json.dumps({"tree": str(trees[i]), "rounds_per_s": rate}),
              flush=True)
    print(json.dumps({"median_rounds_per_s": {
        t: statistics.median(r) for t, r in rates.items()}}), flush=True)


if __name__ == "__main__":
    main()
