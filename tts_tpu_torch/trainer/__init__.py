"""Training runtime of the port (port of ``tts_tpu/trainer``): learning-rate
schedules and optimizers on ``torch.optim`` (``optim.py``), bf16 autocast
(``precision.py``) and the train state of named parameter groups
(``state.py``). The trainer loop, callbacks and logging wait for ROADMAP.md
item 17b."""
