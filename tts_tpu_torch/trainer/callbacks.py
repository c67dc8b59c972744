"""Trainer event callbacks (port of ``tts_tpu/trainer/callbacks.py``,
copied unchanged; reference ``TTS/utils/callbacks.py`` /
``trainer.callbacks``).

Events fire on the host between steps, so arbitrary Python (logging, LR
surgery, early stops) is safe here. Two sources are dispatched per event,
in order:

1. the model's own hook of the same name, when it defines one (the
   reference checks ``model``/``criterion``/``optimizer``; here, as in the
   JAX package, only the model), and
2. user-supplied callables registered via ``Trainer(callbacks={...})`` —
   ``{"on_epoch_end": fn_or_list}``.

Every callable receives the live ``Trainer``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Union

EVENTS = (
    "on_init_start",
    "on_init_end",
    "on_epoch_start",
    "on_epoch_end",
    "on_train_step_start",
    "on_train_step_end",
    "on_keyboard_interrupt",
)

CallbackSpec = Union[Callable, Iterable[Callable]]


class TrainerCallback:
    """Collects per-event callables and dispatches them with the trainer."""

    def __init__(self, callbacks: Optional[Dict[str, CallbackSpec]] = None):
        self._hooks: Dict[str, List[Callable]] = {e: [] for e in EVENTS}
        for name, spec in (callbacks or {}).items():
            if name not in self._hooks:
                raise ValueError(f"Unknown trainer callback event {name!r}; valid: {EVENTS}")
            for fn in [spec] if callable(spec) else list(spec):
                self._hooks[name].append(fn)

    def dispatch(self, event: str, trainer) -> None:
        model_hook = getattr(trainer.model, event, None)
        # `on_epoch_start` on the model is invoked by the trainer itself
        # (its return value controls re-jitting); don't double-fire it here.
        if callable(model_hook) and event != "on_epoch_start":
            model_hook(trainer)
        for fn in self._hooks[event]:
            fn(trainer)

    def __getattr__(self, name: str):
        if name in EVENTS:
            return lambda trainer: self.dispatch(name, trainer)
        raise AttributeError(name)
