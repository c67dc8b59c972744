"""Text front ends: the port's own copies of the jax-free modules of
``tts_tpu/text/`` that it calls, one file each (the XTTS tokenizer's
normalisation; the grapheme vocabulary, cleaners and tokenizer of VITS)."""
