"""Text normalisation for the XTTS tokenizer: the port's own copies of the
jax-free modules of ``tts_tpu/text/`` that it calls, one file each."""
