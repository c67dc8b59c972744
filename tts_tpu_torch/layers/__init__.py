"""Shared network layers of the port (counterparts of ``tts_tpu/layers/``)."""
