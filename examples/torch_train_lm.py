"""End-to-end LM training on the port: wraps
``repro_torch.launch.train``. The default trains a reduced model for a
quick demo; ``--preset full --arch smollm-135m`` is the real
~135M-parameter run. Arguments after the defaults override them
(``--device cpu`` runs on the CPU; the card is the default).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
"""
import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
DEFAULTS = ["--arch", "smollm-135m", "--preset", "tiny", "--steps", "200",
            "--batch", "8", "--seq", "256", "--ckpt-dir",
            "runs/torch_train_lm"]


def main():
    cmd = ([sys.executable, "-m", "repro_torch.launch.train"] + DEFAULTS
           + sys.argv[1:])
    print("running:", " ".join(cmd))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    raise SystemExit(subprocess.call(cmd, env=env))


if __name__ == "__main__":
    main()
