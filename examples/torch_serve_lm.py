"""Batched serving on the port: prefill + greedy decode on any assigned
architecture via ``repro_torch.launch.serve``. Arguments after the
defaults override them (``--device cpu`` runs on the CPU; the card is the
default).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch xlstm-350m
"""
import os
import subprocess
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
DEFAULTS = ["--arch", "smollm-135m", "--preset", "tiny", "--batch", "4",
            "--prompt-len", "32", "--steps", "16"]


def main():
    cmd = ([sys.executable, "-m", "repro_torch.launch.serve"] + DEFAULTS
           + sys.argv[1:])
    print("running:", " ".join(cmd))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    raise SystemExit(subprocess.call(cmd, env=env))


if __name__ == "__main__":
    main()
