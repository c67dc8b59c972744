"""Voice conversion of the port (port of ``tts_tpu/vc/``, reference
``TTS/vc/``): FreeVC with its WavLM content encoder, inference only."""
