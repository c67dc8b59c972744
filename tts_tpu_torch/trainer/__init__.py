"""Training runtime of the port (port of ``tts_tpu/trainer``): the trainer
loop on one device (``trainer.py``), its callbacks and dashboard loggers
(``callbacks.py``, ``logging.py``), learning-rate schedules and optimizers
on ``torch.optim`` (``optim.py``), bf16 autocast (``precision.py``) and the
train state of named parameter groups (``state.py``)."""
