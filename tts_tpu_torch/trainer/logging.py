"""Dashboard loggers (port of ``tts_tpu/trainer/logging.py``, copied
unchanged; reference trainer ``logger_factory``, ``encoder/utils/
training.py:83``, and the ``train_log``/``eval_log``/``test_log`` hooks,
``vits.py:1350-1462``).

TensorBoard (``torch.utils.tensorboard``, which needs the ``tensorboard``
package) is the default dashboard (``config.dashboard_logger``); W&B,
ClearML and Aim are optional. Each missing package degrades to the console
logger with a warning; the trainer prints the scalars itself.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = [
    "AimLogger",
    "ClearMLLogger",
    "ConsoleLogger",
    "TensorBoardLogger",
    "WandbLogger",
    "logger_factory",
]


class ConsoleLogger:
    """No-op dashboard: scalar prints are handled by the Trainer itself."""

    def add_scalars(self, scope: str, scalars: Dict[str, float], step: int):
        pass

    def add_figures(self, scope: str, figures: Dict, step: int):
        """Shows nothing; closes the figures (matplotlib keeps every open one)."""
        if figures:
            import matplotlib.pyplot as plt

            for fig in figures.values():
                if fig is not None:
                    plt.close(fig)

    def add_audios(self, scope: str, audios: Dict[str, np.ndarray], step: int, sample_rate: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class TensorBoardLogger(ConsoleLogger):
    """TensorBoard event writer (reference default dashboard)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir=log_dir)

    def add_scalars(self, scope: str, scalars: Dict[str, float], step: int):
        for k, v in scalars.items():
            try:
                self.writer.add_scalar(f"{scope}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def add_figures(self, scope: str, figures: Dict, step: int):
        for k, fig in figures.items():
            if fig is None:
                continue
            self.writer.add_figure(f"{scope}/{k}", fig, step)
            import matplotlib.pyplot as plt

            plt.close(fig)

    def add_audios(self, scope: str, audios: Dict[str, np.ndarray], step: int, sample_rate: int):
        for k, wav in audios.items():
            if wav is None:
                continue
            wav = np.asarray(wav, np.float32).reshape(-1)
            peak = np.abs(wav).max()
            if peak > 1.0:
                wav = wav / peak
            self.writer.add_audio(f"{scope}/{k}", wav[None, :], step, sample_rate=sample_rate)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


class WandbLogger(ConsoleLogger):
    """Weights & Biases dashboard (reference ``trainer.logging.WandbLogger``).
    Requires the optional ``wandb`` package."""

    def __init__(self, config, output_path: str):
        import wandb  # gated optional dependency

        self.run = wandb.init(
            project=getattr(config, "project_name", None) or "tts_tpu",
            name=getattr(config, "run_name", None),
            dir=output_path,
            config=config.to_dict() if hasattr(config, "to_dict") else None,
        )
        self._wandb = wandb

    def add_scalars(self, scope: str, scalars, step: int):
        numeric = {}
        for k, v in scalars.items():
            try:  # tolerate non-numeric aux values like TensorBoardLogger
                numeric[f"{scope}/{k}"] = float(v)
            except (TypeError, ValueError):
                pass
        self.run.log(numeric, step=step)

    def add_figures(self, scope: str, figures, step: int):
        self.run.log(
            {f"{scope}/{k}": self._wandb.Image(f) for k, f in figures.items() if f is not None},
            step=step,
        )

    def add_audios(self, scope: str, audios, step: int, sample_rate: int):
        self.run.log(
            {
                f"{scope}/{k}": self._wandb.Audio(
                    np.asarray(w, np.float32).reshape(-1), sample_rate=sample_rate
                )
                for k, w in audios.items()
                if w is not None
            },
            step=step,
        )

    def close(self):
        self.run.finish()


class ClearMLLogger(TensorBoardLogger):
    """ClearML tracking: attaches a Task (auto-captures the TensorBoard
    stream, the reference's integration mode). Requires ``clearml``."""

    def __init__(self, config, output_path: str):
        from clearml import Task  # gated optional dependency

        self.task = Task.init(
            project_name=getattr(config, "project_name", None) or "tts_tpu",
            task_name=getattr(config, "run_name", None) or "run",
            output_uri=output_path,
        )
        super().__init__(os.path.join(output_path, "logs"))


class AimLogger(ConsoleLogger):
    """Aim experiment tracker. Requires the optional ``aim`` package."""

    def __init__(self, config, output_path: str):
        from aim import Run  # gated optional dependency

        self.run = Run(
            repo=output_path, experiment=getattr(config, "project_name", None) or "tts_tpu"
        )

    def add_scalars(self, scope: str, scalars, step: int):
        for k, v in scalars.items():
            try:  # tolerate non-numeric aux values like TensorBoardLogger
                v = float(v)
            except (TypeError, ValueError):
                continue
            self.run.track(v, name=k, step=step, context={"scope": scope})

    def close(self):
        self.run.close()


_DASHBOARDS = {
    "wandb": WandbLogger,
    "clearml": ClearMLLogger,
    "aim": AimLogger,
}


def logger_factory(config, output_path: str):
    """Build the dashboard logger named by ``config.dashboard_logger``
    (reference trainer ``logger_factory``: tensorboard | wandb | clearml |
    aim). Missing optional packages degrade to console with a warning."""
    name = (getattr(config, "dashboard_logger", "tensorboard") or "console").lower()
    if name == "tensorboard":
        try:
            return TensorBoardLogger(os.path.join(output_path, "logs"))
        except Exception as e:  # pragma: no cover - tensorboard missing
            print(f" [!] TensorBoard unavailable ({e}); falling back to console logging")
            return ConsoleLogger()
    if name in _DASHBOARDS:
        try:
            return _DASHBOARDS[name](config, output_path)
        except ImportError as e:
            print(f" [!] dashboard_logger={name!r} needs its optional package ({e}); using console")
            return ConsoleLogger()
    if name in ("console", "", "none"):
        return ConsoleLogger()
    print(f" [!] Unknown dashboard_logger {name!r}; using console")
    return ConsoleLogger()
