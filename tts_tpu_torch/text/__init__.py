"""Text front ends: the port's own copies of the jax-free modules of
``tts_tpu/text/`` that it calls, one file each (the XTTS tokenizer's
normalisation; the VITS vocabularies, cleaners and tokenizer; the phoneme
front end: punctuation, the rule G2P of ``en_g2p`` and ``latin_g2p``, and
the phonemizer backends)."""
