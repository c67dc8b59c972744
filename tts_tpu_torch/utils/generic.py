"""Experiment bookkeeping (port of ``tts_tpu/utils/generic.py``, copied
unchanged; reference ``TTS/utils/generic_utils.py``
``get_experiment_folder_path``/``get_commit_hash``).

Run folders are stamped ``<run_name>-<Month-Day-Year_HH+MM>-<git hash>`` so
concurrent runs never collide and every checkpoint folder records the code
version that produced it.
"""

from __future__ import annotations

import datetime
import os
import subprocess


def get_commit_hash() -> str:
    """Short git hash of the current checkout, or 0000000 outside a repo."""
    try:
        return (
            subprocess.check_output(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stderr=subprocess.DEVNULL,
            )
            .decode()
            .strip()
        )
    except (OSError, subprocess.CalledProcessError):
        return "0000000"


def get_experiment_folder_path(root_path: str, run_name: str) -> str:
    """Unique run directory under ``root_path`` (not created)."""
    date_str = datetime.datetime.now().strftime("%B-%d-%Y_%I+%M%p")
    return os.path.join(root_path, f"{run_name}-{date_str}-{get_commit_hash()}")
