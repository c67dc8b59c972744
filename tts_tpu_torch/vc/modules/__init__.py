"""VC auxiliary modules (port of ``tts_tpu/vc/modules/``): the WavLM content
encoder."""
