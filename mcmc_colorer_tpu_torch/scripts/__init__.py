"""The baseline and validation scripts, run as modules:

    python -m mcmc_colorer_tpu_torch.scripts.run_baseline_configs [--small]
    python -m mcmc_colorer_tpu_torch.scripts.validate_stats
    python -m mcmc_colorer_tpu_torch.scripts.validate_matrix

Counterparts of the JAX package's ``scripts/run_baseline_configs.py``,
``validate_stats.py`` and ``validate_matrix.py``, with the same
configurations, seeds, report keys and verdicts.  Each runs on the card
(``--device``, default ``cuda``; it raises without one) or, when asked,
on the CPU (``--device cpu``), and writes its report under the
checkout's git-ignored ``build/`` unless given ``--out``.
"""

from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def device_report(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``"cpu"``."""
    import subprocess

    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def write_json(obj, path, **kw) -> None:
    """``json.dump`` to ``path``, making its directory first."""
    import json
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, **kw)
