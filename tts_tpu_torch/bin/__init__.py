"""Command-line tools of the port (counterparts of ``tts_tpu/bin/``)."""
