#!/usr/bin/env python3
"""Drive the PyTorch port (``tts_tpu_torch``) once on one CUDA card.

Run from the root of a checkout, with no arguments (every phase)::

    python3 chip_smoke.py

Phases; each raises on failure and the script then exits non-zero:

1. environment: torch / CUDA / nvcc versions, the card's name and power
   limit; TF32 is switched off for the comparison phases;
2. build: the hand-written kernels (K1, K4 and K2) are
   compiled from ``tts_tpu_torch/csrc``, one ``nvcc`` each, at once
   (ptxas register / shared-memory use printed);
3. kernels: each kernel against its plain PyTorch version on the card at the
   decode shapes (B 1 and 4, S 685, 720 and 1024, H 16, dh 64, fp32 and
   bf16 caches, per-row, scalar and the real decode's lengths; Tortoise's
   B 16 at S 600, XTTS v1's B 1 at S 1650 and Bark's B 1 at S 656 and 947,
   timed too), each call
   made twice and the two results required bit-identical; then timed
   beside its bound, its plain version and one PyTorch library call
   (``scaled_dot_product_attention``) computing the same function;
4. slice: XTTS v2 at full width (``XttsConfig()``; fp32 weights built and
   drawn on the card from a seed) conditions on a reference wav and decodes 40 greedy tokens twice,
   through the kernel and through the plain attention; tokens must match
   and latents agree within 1e-4. Then the decode step is timed in bf16;
5. serving: the same weights (GPT in bf16) go into a model directory, the
   port's HTTP server starts from its command line (``--stream_batch 4``) on
   a free local port, and 4 concurrent ``/api/tts-stream`` requests and one
   ``/api/tts`` request clone the reference voice. The decode-attention
   launch count of this phase proves the decode went through the kernel,
   and each request decodes ``max_mel_tokens - 3`` tokens (602), a
   stream's last chunk cut short there. Then one stream on the idle server, and its time to first audio split
   into conditioning, prefill, one chunk's decode and its vocoding. Last,
   one call of the ``tts`` command line (``tts_tpu_torch.bin.synthesize``)
   on the same model directory clones the voice into a file; the kernel's
   launches in that call must be 30 x its decode steps;
6. VITS: the LJSpeech VITS recipe as published, phonemes from the rule G2P
   (``english_cleaners``, ``use_phonemes=True``, ``phoneme_language="en-us"``,
   blanks; the ``VitsArgs`` defaults, the embedding sized by the phoneme
   set; fp32 weights drawn from seed 0, TF32 off) synthesizes three
   sentences on the card and, on the same weights and the same noise
   (drawn once on the host, by shape), on the CPU: ``y_lengths`` must be
   equal and the waveforms agree within 1e-4. Then three concurrent
   ``/api/tts`` requests through the server, ``/details``, ``/locales``,
   ``/voices`` and a ``POST /process``, one file through
   ``TTS.tts_to_file`` and one through the ``tts`` command line (the same
   samples within one int16 step), and the timings: real-time factor at B=1
   for a short, a medium and a long sentence, the time of each stage of the
   medium one, the device busy share and top kernels under
   ``torch.profiler``, and the peak device memory. VITS runs no
   hand-written kernel (the JAX package reaches no Pallas kernel there);
7. batched VITS: the same recipe and seed from a model directory. A
   three-sentence request through the ``Synthesizer``'s packed path on the
   card and on the CPU on host noise (plans and ``y_lengths`` equal,
   waveform within 1e-4); on the card, each packed segment (batch noise
   layout) against its sentence decoded alone with masks (within 1e-4);
   the request's wall time packed against the serial loop, with kernels
   and busy share under ``torch.profiler``; the packed decode timed under
   plans billing rows by eights (the JAX package's) and by ones; the
   server from its command line with ``--max_batch 1`` and ``--max_batch
   4`` answering 8 concurrent ``/api/tts`` requests (2 short, 4 medium,
   2 long), with the batch sizes its worker formed and the plans'
   utilization; peak memory. ``decode_attention`` must not launch;
8. multi-speaker VITS: the VCTK recipe (109 speakers, the flags set on
   ``model_args``), the multilingual recipe (16 kHz, the multi-phonemizer,
   language and speaker embeddings, the M-AILABS language codes) and a
   512-wide d-vector model, full width from seed 0. VCTK card against CPU
   on host noise for two speakers, on one sentence and on one packed
   three-sentence request (``y_lengths`` and plans equal, waveform within
   1e-4; the two speakers differ); one packed grid of four speakers, each
   segment within 1e-4 of its own masked decode; ``/api/tts`` with
   ``speaker_id`` (an unknown one answered 400), ``/details`` listing the
   109 speakers, ``tts --list_speaker_idxs`` and a ``--speaker_idx`` file
   within one int16 step of ``TTS.tts_to_file``'s; the serving mix over
   four speakers with ``--max_batch 1`` and ``4``; the medium sentence's
   latency beside phase 6's, busy share, peak memory. Multilingual: card
   against CPU for each language a phonemizer here serves, and one batched
   turn mixing them and their speakers. d-vectors: card against CPU.
   ``decode_attention`` must not launch;
9. zoo, voice conversion and VITS variants, full width from seed 0: the
   VCTK recipe saved as a zoo directory (reference-layout
   ``model_file.pth``, ``config.json``, ``speakers.pth``) under a temporary
   ``TTS_HOME`` with a copy of the catalog as ``TTS_TPU_MODELS_FILE``
   (any fetch raises); ``TTS(model_name=...)`` and ``tts --model_name``
   against the same files loaded by path; a p225 recording the port speaks
   converted to p226, card against CPU on host noise; the MB-iSTFT-VITS
   decoder (arXiv:2210.15975's widths) and an encoder-rate model (44.1 kHz
   out, encoders at 22.05 kHz, ``interpolate_z``), card against CPU on three
   sentences, the medium sentence's latency and RTF; the grouped
   dispatch's ``overhead`` fitted on the iSTFT model (a dispatch's floor
   over its marginal ms per frame·row); one grouped batcher turn card
   against CPU and the serving mix with ``--max_batch 1`` and 4 on the
   iSTFT model, with the groups formed, each group's decoded lengths
   equal to its planned ones (F16). ``decode_attention`` must not
   launch;
10. GlowTTS with Multiband-MelGAN, the ``tts`` command line's default
    pairing, at the LJSpeech recipes' widths (``phoneme_cleaners``,
    ``en-us`` phonemes from the rule G2P and the ``GlowTTSConfig``
    defaults; the ``MultibandMelganConfig`` defaults), fp32 weights from
    seed 0: the fidelity fixtures ``glow_tts.npz`` and
    ``multiband_melgan.npz`` replayed on the card through the port's
    converters (``y_lengths`` equal and mel RMSE under 5e-3; under 0.5 dB);
    the three phase 6 sentences card against CPU (``y_lengths`` equal, mel
    and waveform within 1e-4); latency and RTF at B=1 with a stage split
    (encoder with durations, path expansion, flow decoder, host bridge,
    MB-MelGAN by CUDA events), MB-MelGAN's TFLOP/s, the busy share and
    kernels under ``torch.profiler``, peak memory; Griffin-Lim without a
    vocoder, card against CPU after one ``np.random.seed``; the pair by zoo
    name from reference-layout directories (the vocoder's ``stats_path``
    rewritten, F17), equal to the path load; ``tts --vocoder_path`` within
    one int16 step of the API; the server with ``--vocoder_path`` and
    ``--max_batch 4``, which says it serves serially and answers three
    ``/api/tts`` requests. ``decode_attention`` must not launch;
11. Tacotron2-DDC with HiFiGAN at the LJSpeech recipes' widths
    (``phoneme_cleaners``, ``en-us`` phonemes from the rule G2P, the
    ``Tacotron2Config`` defaults with the recipe's ``r=6``; the
    ``HifiganConfig`` defaults), fp32 weights from seed 0, norms folded as
    in a converted checkpoint, the stopnet's weight 0 and bias -10 so that
    every decode runs its whole budget. The model is saved in the reference
    layout with ``"r": 2`` beside the weights and loaded back: ``r_init`` 6
    from the 480-wide projection, ``r`` 2 from the checkpoint (F20). Then:
    ``tacotron2.npz`` teacher-forced on the card (mel RMSE under 5e-3); the
    short and medium phase 6 sentences card against CPU (``mel_lengths``
    equal, mel and waveform within 1e-4, the mel's largest difference per
    100 decode steps printed); the DCA recipe card against CPU on the short sentence; B = 4
    rows against their own B = 1 decodes at 400 steps (location attention
    gives padded tokens no weight, so a row cannot move with the padding);
    the stopnet firing at step 1 (bias +10), which leaves at the first stop
    check; ms per decode step at B = 1 and 4 (the slope between 100 and
    300 steps), kernels per step and the busy share under
    ``torch.profiler``; latency, RTF and HiFiGAN's share at natural length
    (``inference(max_steps=3 × tokens)``, LJSpeech's pace at r = 2) and at
    the whole budget through ``Synthesizer.tts``; the pair by zoo name
    (``tacotron2-DDC`` with ``hifigan_v2``) equal to the path load; ``tts
    --vocoder_path`` within one int16 step of the API; the server with
    ``--max_batch 4``, which serves serially; peak memory.
    ``decode_attention`` must not launch;
12. the speaker encoders, YourTTS voice cloning and the ForwardTTS family,
    fp32 weights from seed 0: ``speaker_encoder_resnet.npz`` and
    ``fastpitch.npz`` replayed on the card through the port's reference
    loaders; the recipe's SE-ResNet34 (64 mels, ``log_input``, 512 wide, 16
    kHz) and the ``BaseEncoderConfig`` LSTM (80 mels, 3 × 768 → 256), each
    written as a reference-layout ``model_se.pth.tar`` and loaded by
    ``load_speaker_encoder``, card against CPU on a 3 s and a 10 s clip
    (d-vectors within 1e-4, finite) with their ms per clip; YourTTS as the
    recipe publishes it (graphemes, ``multilingual_cleaners``, 512-wide
    d-vectors) cloning a 3 s clip card against CPU on host noise
    (``y_lengths`` equal, waveform within 1e-4), the encoder's share of a
    cloned request and its latency beside a named speaker's, ``TTS(
    encoder_path=...)``, ``tts --encoder_path`` (one int16 step), the
    server's ``/api/tts?speaker_wav=`` (serial) and ``your_tts`` by zoo name
    from a directory with ``model_se.pth.tar`` (F23); FastPitch as the
    LJSpeech recipe publishes it with HiFiGAN, card against CPU on the three
    phase 6 sentences (mel and waveform within 1e-4), FastSpeech2 and
    SpeedySpeech card against CPU on the short one, latency, RTF, the stage
    split, busy share and kernels, ``fast_pitch`` by zoo name with
    ``hifigan_v2``, the command line and the server (serial); peak memory.
    ``decode_attention`` must not launch;
13. Overflow and NeuralHMM with HiFiGAN, then AlignTTS and DelightfulTTS,
    at the LJSpeech recipes' widths (Overflow's and NeuralHMM's
    ``phoneme_cleaners`` with ``en-us`` phonemes, NeuralHMM's audio;
    AlignTTS's graphemes; DelightfulTTS's phonemes, its embedding sized by
    the phoneme set), fp32 weights from seed 0. Overflow's transition bias
    (the output net projection's last row) is calibrated on the card: of a
    grid of biases, the one whose medium-sentence decode ends nearest 3
    frames a state, its decisions at least 1e-3 from the threshold (the
    grid is printed). The model is saved in the reference layout with
    stand-in mel statistics as ``mean``/``std`` and loaded back through
    ``load_reference_overflow``. Then: the three phase 6 sentences card
    against CPU (``y_lengths`` equal, mel within 1e-4 with its largest
    difference per 100 frames and the decisions' smallest distance from
    the threshold; the waveform with HiFiGAN on the short and medium ones);
    B = 4 rows against their own B = 1 decodes; a decode whose transition
    never fires (bias -20), cut at its budget with every step run, card
    against CPU; ms per frame at B = 1 and 4 (the slope between 256 and 768
    frames of that decode), kernels per frame and the busy share; latency
    and RTF at natural length, the medium sentence's stages (encoder,
    sampling loop, post-flow, bridge, HiFiGAN) and its latency at 3 frames
    a state; ``overflow`` and ``neural_hmm`` by zoo name with
    ``hifigan_v2`` from reference-layout directories, equal to the path
    load; ``tts --vocoder_path`` within one int16 step of the API; the
    server with ``--max_batch 4``, serial. NeuralHMM (its own calibrated
    bias) card against CPU on the short and medium sentences. AlignTTS
    (mel, short and medium) and DelightfulTTS (mel and its joint vocoder's
    waveform, F28, short) card against CPU with the durations' smallest
    distance from a .5 boundary, the medium sentence's latency and RTF
    through ``Synthesizer.tts`` (AlignTTS with HiFiGAN), and one
    ``TTS.tts_to_file`` each; peak memory. ``decode_attention`` must not
    launch;
14. the remaining vocoders at full width, fp32 weights from seed 0:
    ParallelWaveGAN (``ParallelWaveganConfig``: 30 layers in 3 stacks,
    64/128/64 channels, upsampling [4, 4, 4, 4]), UnivNet (``UnivnetConfig``:
    64 noise and 32 hidden channels, LVC blocks [8, 8, 4]), WaveGrad
    (``WavegradConfig``: 768 wide, [4, 4, 4, 2, 2], 50 test steps; its FiLM
    output convs scaled by 0.1 and its head so that the predicted noise has
    a deviation of 1, as random weights otherwise diverge), WaveRNN
    (``WavernnConfig``: ``mold``, 512-wide GRUs, [4, 8, 8]) and the iSTFT
    generator at the MB-iSTFT-VITS decoder's widths. Card against CPU on a
    64-frame mel with the noise drawn once on the CPU (within 1e-4:
    ParallelWaveGAN, UnivNet and the iSTFT generator; WaveGrad's ``y``
    before the clip after 50 steps, its largest difference after each 10
    steps and that of the FiLM positional table printed; WaveRNN's
    teacher-forced logits and ``generate`` over ``WAVERNN_CHECK_FRAMES``
    (10) frames, a flipped mixture component traced to its step and Gumbel
    margin); the four
    fidelity fixtures on the card; each vocoder alone on the medium
    sentence's mel at the Tacotron2 phase's natural length (latency, RTF,
    operations, kernels and busy share, working memory; WaveGrad's two
    branches of a step; WaveRNN's us a sample on a 16-frame clip and kernels
    a sample on a 6-frame one); ``en/ek1/tacotron2``,
    ``en/ljspeech/tacotron2-DDC_ph`` and ``nl/mai/tacotron2-DDC`` by zoo
    name with their default vocoders from reference-layout directories,
    equal to the path load; ``tts --vocoder_path`` (UnivNet) within one
    int16 step of the API; one WaveRNN ``TTS.tts_to_file``; the server with
    WaveGrad and ``--max_batch 4``, serial. The surfaces' Tacotron2 stops at
    step 1 and decodes at the recipe's r = 6: 6 frames a sentence.
    ``decode_attention`` must not launch;
15. GST and Capacitron on Tacotron2, then Tacotron v1, fp32 weights from
    seed 0 at full width, the stopnet never firing: the blizzard2013
    Capacitron Tacotron2 recipe (dynamic convolution attention, r = 2,
    Capacitron 128, 24 kHz) with a 24 kHz HiFiGAN, saved in the reference
    layout; a Tacotron2 with GST at the GST defaults (512 wide, 4 heads, 10
    tokens) with the LJSpeech HiFiGAN; the blizzard2013 Capacitron Tacotron
    v1 recipe (CBHG 128, 513 linear bins) with Griffin-Lim, from the port's
    own checkpoint. Each card against CPU on the short sentence with a
    style reference at its whole budget, on the same host draws (the GST
    style vector, Capacitron's ``z`` of the posterior and of the prior, the
    mel or linear spectrogram, the audio: within 1e-4; Griffin-Lim's
    magnitude spectrogram within 1e-2 relative L2, its waveform's share of
    the peak printed); the medium sentence with a style reference at
    natural length (3 steps a token): latency, RTF, ms per decode step, the
    kernels and busy share under ``torch.profiler``. Then the zoo's
    ``capacitron-t2-c50`` and ``capacitron-t2-c150_v2`` by name with the
    blizzard2013 ``hifigan_v2``, with and without a style reference, equal
    to the path load; ``tts --model_name --capacitron_style_wav
    --capacitron_style_text`` and ``/api/tts?style_wav=`` (served serially)
    within one int16 step of the API; peak memory. ``decode_attention``
    must not launch;
16. FreeVC voice conversion with WavLM-Large, the zoo's ``freevc24``, fp32
    weights from seed 0 at full width in the reference layout:
    WavLM-Large (``wavlm_large_config()``, 24 pre-LN layers 1024 wide with
    the gated relative position bias) at ``$TTS_HOME/wavlm/WavLM-Large.pt``
    and FreeVC at ``FreeVCConfig()`` (with its in-model speaker encoder) as
    the zoo directory's ``model.pth`` and ``config.json``. Card against CPU
    on a 3 s source and a 3 s target at 22.05 kHz: WavLM's features (within
    1e-4 of their peak), the target's speaker embedding and, on host noise,
    the converted waveform (within 1e-4). Then WavLM's ms on a 3 s and a 10
    s source, FreeVC's decode ms, ``voice_conversion_from_files`` end to end
    (ms, source and output seconds per wall second), its busy share and top
    kernels under ``torch.profiler``, and the output rate against F42 (320
    samples a frame labelled 24 kHz); ``TTS(model_name=".../freevc24")``
    equal to the path load; ``tts --model_name --source_wav --target_wav``
    within one int16 step of ``voice_conversion_to_file``;
    ``tts_with_vc_to_file`` on phase 6's LJSpeech VITS loaded by path, into
    FreeVC loaded by name on first use; peak memory. ``decode_attention``
    must not launch;
17. XTTS v1 at full XTTS width (``XttsConfig()`` without the perceiver,
    fp32 weights built and drawn on the card from seed 0): a 30 s clip's one coarse mel (``n_fft``
    4096, hop 1024) gives 646 prompt latents; 40 greedy tokens through K1
    and through the plain attention must be identical (latents within
    1e-4) and launch K1 30 times a step; the time to first audio in parts
    and ms a decode step behind the long prompt; ``xtts_v1.1`` by zoo name
    equal to the path load;
18. Tortoise at the default ``TortoiseArgs`` (AR 30 x 1024 x 16, diffusion
    1024 x 10, CLVP 768 x 20 a side, the bundled UnivNet 32 channels), fp32
    weights drawn on the card from seed 0 (``init_params``' rules; the CPU
    model a copy), random latent generators and mel norms drawn
    here: card against CPU within 1e-4 of each peak on short inputs (the
    AR's conditioning and teacher-forced pass, 8 greedy decode steps, one
    guided diffusion step, CLVP's scores, the vocoder on a 20-frame mel);
    16 sampled candidates' codes identical through K1 and the plain
    attention on one generator, K1 launching 30 times a step; one whole
    ``synthesize`` from a voice folder and one from the random voice (16
    candidates, ``TORTOISE_CAP`` codes each since random weights never stop,
    30 DDIM steps with classifier-free guidance) with their stages and
    peak memory, the random voice's busy share on a 16-code call
    (``TORTOISE_PROFILE_CAP``); ``tortoise-v2`` by zoo name
    from the reference layout equal to the path load; ``tts --model_name
    --voice_dir`` within one int16 step of ``TTS.tts_to_file`` (the zoo
    directory's AR head emits the stop token first, so those calls decode
    one code a candidate, a depth cut of the surfaces);
19. Bark at the zoo's widths (24 x 1024 x 16 in all three GPTs, the text
    model's head 10,048 wide over 129,600 tokens, F48; EnCodec at the 24 kHz
    model's dims), fp32 weights drawn on the card from seed 0 (the CPU
    model a copy): card against CPU within 1e-4
    of each peak on short inputs (the semantic prefill with
    ``merge_context``, 8 greedy decode steps, one coarse window's prefill
    and 20 greedy tokens, one fine window's logits, EnCodec on 50 frames);
    sampled semantic and coarse tokens identical through K1 and the plain
    attention on one generator, K1 launching 24 times a step; HuBERT-base
    and its tokenizer card against CPU on a 3 s clip, ``generate_voice``'s
    prompt saved as ``clone.npz``; one ``synthesize`` at random and one
    from that prompt, each at a 2 s budget (``BARK_BUDGET_S``, a depth cut:
    random weights never emit EOS, so a call runs its whole budget; the
    default is 8 s), each with its
    stages, ms a decode step and K1's launches, then the random voice at a
    0.25 s budget under ``torch.profiler`` (busy share, top kernels), and peak
    memory; ``bark`` by zoo name from the reference layout (its semantic
    head set to emit EOS first for the surfaces' sentence) equal to the
    path load, ``tts --model_name --voice_dir
    --speaker_idx`` within one int16 step of ``TTS.tts_to_file``, one
    ``/api/tts`` request; Tortoise's wav2vec2 aligner at
    wav2vec2-large-robust's widths card against CPU on one clip;
20. int8 weight-only serving through K4 (``csrc/int8_linear.cu``): K4
    against its plain version at the path's shapes (K 1024 with N 3072,
    1024, 4096, K 4096 with N 1024, the heads 1026, 8194 and 10,048; M 1,
    4, 16, 513, 1024; bf16 and fp32; the conditioning encoders' K 80 and
    2730) and each of its three kernels forced at M 1-16, each call made
    twice and required bit-identical; the tensor-core instructions of its
    kernels in the built library's SASS; then timed beside its bound, the
    plain version, a library yardstick and ``F.linear`` on a float weight,
    the old CUDA-core kernel against the tensor-core ones at M 1-16, and
    the host cost of a call split into its parts; XTTS v2 quantized (fp32
    from seed 0): card against CPU on the conditioning, the prefill and 8
    greedy steps (within 1e-4 of each peak), 40 greedy tokens identical
    through K4 and the plain version, 121 launches a step; then from a
    model directory whose ``config.json`` sets ``gpt_int8_weights``,
    through ``TTS``: the resident bytes against the float load, ms a bf16
    decode step at B=1 and B=4 beside the float model's in turns, one
    ``/api/tts-stream`` request through the ``StreamBatcher``; Tortoise's
    AR stack (16 greedy candidates x 60 steps) and Bark's three GPTs (the
    semantic stage and one coarse window) at their zoo widths, drawn on the
    card: tokens identical through K4 and the plain version, launches a step
    (121, 97), ms a step, resident bytes; last, K4 timed at every other
    (M, K, N, type) those runs launched, counted as they ran;
21. VITS training through MAS (K2, ``csrc/mas.cu``): the LJSpeech recipe's
    GAN step (``Vits.make_train_step``, the recipe's AdamW and
    ExponentialLR) at full width on a synthetic batch from seed 0 (32 rows,
    61-381 ids with blanks, 2-10 s of 22.05 kHz audio, the longest row 861
    frames, its linear spectrogram). K2 against its plain version at these
    shapes on random, tied, ragged and bf16 scores and an item without
    tokens, the direction bits where the plan puts them, in the scratch
    buffer and in shared memory; and at the ring kernel's boundaries (383 x
    203, 385 x 861, 513 x 99, 1030 x 861, an unaligned view with a bool
    mask, 4200 tokens through the columns kernel): each call made twice,
    paths identical, repeats bit-identical; then K2 timed beside its bound
    and its plain version (no library call computes MAS), with the bits in
    the other place, at the aligners' 190 tokens, with bf16 values and a
    bool mask, and against the columns kernel (the first design) in the same
    run; host
    microseconds a call; K2's parts by ``clock64`` in block 0, as
    ``scripts/k2_probes.py`` reads them. One step at a tiny width card
    against CPU (fp32, TF32 off, dropout on, the same host draws and
    alignment): losses within
    1e-4, gradients within 1e-4 of each tensor's peak (the stochastic
    duration predictor's against a float64 run, see
    ``train_step_card_against_cpu``). Then 2 warm-up and 5 timed steps in
    fp32 and under bf16 autocast: ms a step, the losses (finite), peak
    memory, busy share and top kernels of one profiled step; K2 launches
    once a step;
22. VITS training through the trainer loop, the data pipeline and
    ``train_tts``: an LJSpeech-layout corpus (80 clips of synthetic 22.05
    kHz 16-bit audio, 2-10 s, texts of ~a token per 2.26 frames) under a
    temporary directory; the LJSpeech recipe (B=32, eval batch 16, 16 clips
    to evaluate, phonemes from the rule G2P, ``print_step`` 1, the console
    dashboard) through ``tts_tpu_torch.bin.train_tts.main`` on the card, one
    epoch of two steps, a full evaluation and a test sentence, once with
    ``num_loader_workers`` 0 and once with 4 (threads): ms a step on the
    trainer's clock beside phase 21's bare step, the loader's wait before
    each step, the busy share over step 2, peak memory; ``--continue_path``
    on the first run (the step count, the best loss and the optimizer's
    update count go on), one more epoch; its ``best_model.pth`` spoken
    through the ``tts`` command line (finite, non-empty); the multilingual
    recipe (speaker and language embeddings, both balancer samplers) over
    48 of the clips relabelled as four speakers in two languages, one step
    at B=32; a tiny config through ``Trainer.fit`` on the CPU and on the
    card, single-speaker and with speakers and languages (the same host
    draws and the CPU's alignments): each step's losses within 1e-4 of
    their peak. K2 launches once a train step
    and once an evaluation batch; its card checks run here when phase 21
    does not.
23. Vocoder training (``phase_vocoder_train``): 106 clips of synthetic
    22.05 kHz audio (2-10 s) under a temporary directory; the LJSpeech
    HiFiGAN recipe (v1 at its published width, B=32, 8192-sample segments,
    noise augmentation, MPD and MSD, the mel L1, feature matching and mse)
    through ``tts_tpu_torch.bin.train_vocoder.main`` with 4 loader threads:
    an epoch of three steps, an evaluation and a checkpoint, ms a step on
    the trainer's clock, the loader's wait, the busy share over step 2
    (kernel time summed, and the share of the step in which the device ran
    anything: cuDNN's kernels overlap on several streams), peak memory, the
    run's stages; ``--continue_path`` for a second epoch (the step and the
    optimizers' update counts go on); the checkpoint's generator through
    the ``Synthesizer``'s vocoder path, bit-equal to the trained module on
    an eval mel. Two steps each of the multi-band MelGAN (PQMF, sub-band
    STFT loss, the discriminator gated off), UnivNet (noise drawn from the
    step's generator, F55), WaveGrad (the generic step) and WaveRNN (mold)
    recipes at their widths. Each family's tiny fit through
    ``Trainer.fit`` on the CPU and on the card with the same weights and
    host draws: every loss within 1e-4 of its value (the two families
    under an STFT loss at lr 1e-6, ``tiny_vocoder_configs``). K1, K4 and K2
    must launch 0 times on this path.

Phase selection: ``python3 chip_smoke.py 20`` (or any phase numbers) runs
phases 1 and 2 and the ones named (5 brings 4); without arguments every
phase runs.

It prints the card's name and power limit, then ``{"kernels": [...]}``
(K1, K4 and K2, K2's launches those of phases 21 and 22) on the line
before the last and, as the last line, ``{"ok": true, "device": {...}}``. The port must have imported nothing of ``tts_tpu``, JAX, flax,
``tokenizers`` or ``transformers`` by then. Without CUDA, or outside a
checkout, it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, DH = 16, 64  # XTTS v2 attention heads and head width
STREAM_CHUNK = 20  # tokens per streamed chunk (XTTS default)


T0 = time.time()  # the script's start: every log line shows the seconds since


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def time_host(fn, iters: int = 200, warmup: int = 20) -> float:
    """Milliseconds per call for back-to-back calls (CUDA events around the
    run): includes the host's launch cost, which bounds small ops."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device(fns, rounds: int = 10, replays: int = 10) -> float:
    """Device milliseconds per call: ``rounds`` passes over ``fns`` are
    captured into one CUDA graph, replayed ``replays`` times between CUDA
    events, so the host's launch cost is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * rounds * len(fns))


@contextlib.contextmanager
def plain_decode_attention():
    """The GPT's decode step calls the plain PyTorch attention instead of the
    kernel, for one comparison only."""
    from tts_tpu_torch.models.xtts import gpt_core
    from tts_tpu_torch.ops.decode_attention import decode_attention, decode_attention_torch

    gpt_core.decode_attention = decode_attention_torch
    try:
        yield
    finally:
        gpt_core.decode_attention = decode_attention


@contextlib.contextmanager
def forced_splits(keys: int, splits: int):
    """The kernel's wrapper cuts ``keys`` keys into ``splits`` splits in
    place of its plan's count, for one measurement only."""
    import importlib

    dec = importlib.import_module("tts_tpu_torch.ops.decode_attention")
    plan = dec.split_plan
    dec.split_plan = lambda *args: dec.cut_keys(keys, splits)
    try:
        yield
    finally:
        dec.split_plan = plan


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def built_on(device):
    """Modules built inside this context allocate, and run their default
    initialisation, on ``device``: on a card, a billion parameters in a
    fraction of the CPU's time (their values are drawn again by
    ``init_params(..., device=device)``)."""
    import torch

    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.device(device)


def reference_wav(seconds: float = 6.0, sr: int = 22050, seed: int = 0) -> np.ndarray:
    """A voiced-sounding test clip: a gliding harmonic tone plus noise."""
    t = np.arange(int(seconds * sr), dtype=np.float64) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    wav = wav + 0.02 * np.random.RandomState(seed).randn(len(t))
    return wav.astype(np.float32)


# ---------------------------------------------------------------------------
def phase_environment() -> str:
    import torch

    from tts_tpu_torch.ops.cuda_build import find_nvcc

    nvcc_ver = subprocess.run(
        [find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| nvcc: {nvcc_ver}")
    card = card_line()
    print(card, flush=True)  # name and power limit, exactly as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN convolutions: comparisons run in full fp32")
    return card


KERNEL_SOURCES = ("decode_attention", "int8_linear", "mas")  # K1, K4, K2


def phase_build() -> None:
    """Both kernels' sources built at once, one ``nvcc`` each."""
    from concurrent.futures import ThreadPoolExecutor

    from tts_tpu_torch.ops.cuda_build import load_library

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = list(pool.map(load_library, KERNEL_SOURCES))
    log(f"built {', '.join(os.path.relpath(b.path, REPO) for b in libs)} in "
        f"{time.time() - t0:.1f} s (in parallel)")
    for built in libs:
        for line in built.build_log.splitlines():
            if "entry function" in line:
                kind = "bf16" if "bfloat16" in line else "fp32"
                log(f"  ptxas: {line.strip().split(' for ')[0]} ({kind} instance)")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet, at 700 W
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores


def attention_bound_ms(B: int, n: int, dtype) -> tuple:
    """Least time for one decode-attention call: each input read once (q and
    the valid K/V rows), the fp32 output written once, over the memory rate;
    ~4 flops per K/V element (q.k and p.v) over the fp32 rate. Returns
    ``(ms, "bytes" or "operations", bytes)``."""
    import torch

    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * n * H * DH * elt + B * H * DH * elt + B * H * DH * 4
    flops = 4 * B * n * H * DH
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes)


def phase_kernels(card: str) -> dict:
    """K1 against its plain version at the decode shapes (and repeated calls
    bit-identical), then timed beside its bound, the plain version and one
    library call computing the same function."""
    import torch
    import torch.nn.functional as F

    from tts_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_torch,
        split_plan,
    )

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0

    def check(B, S, dtype, lengths):
        nonlocal n_checks
        q = torch.randn(B, H, DH, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype)
        for cache_len in lengths:
            got = decode_attention(q, k, v, cache_len)
            again = decode_attention(q, k, v, cache_len)
            # bf16: the plain version runs in fp32 on the same bf16 values
            want = decode_attention_torch(q.float(), k.float(), v.float(), cache_len)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst[dtype] = max(worst[dtype], err)
            n_checks += 1
            if not err <= tol[dtype]:
                raise AssertionError(
                    f"decode_attention B={B} S={S} {dtype} cache_len={cache_len}: "
                    f"max abs err {err} > {tol[dtype]}"
                )
            if not torch.equal(got, again):
                raise AssertionError(
                    f"decode_attention B={B} S={S} {dtype} cache_len={cache_len}: two calls on "
                    f"the same inputs differ by {(got - again).abs().max().item()}"
                )

    for B in (1, 4):
        for S in (685, 1024):
            for dtype in (torch.float32, torch.bfloat16):
                lengths = [
                    torch.tensor([(1, 37, S)[(b + r) % 3] for b in range(B)],
                                 dtype=torch.int32, device=dev)
                    for r in range(3)
                ] + [S - 3, torch.tensor(37, device=dev)]
                check(B, S, dtype, lengths)
    # the cache lengths of a real decode (20-token chunks after a ~33-token
    # prefix), at the streaming capacity S=720 and at S=1024 with B=4
    for B, S in ((1, 720), (4, 720), (4, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            check(B, S, dtype, [33, 95, 300])
    # Tortoise's 16 candidates behind a ~60-token prefix with up to 500 codes, and
    # XTTS v1's prompt of one latent a coarse mel frame (646 for 30 s) before
    # the text and the codes
    # Bark's semantic decode (257 prompt positions, up to 399 tokens) and its
    # coarse windows (887 prompt positions, 60 tokens)
    for B, S, lengths in ((16, 600, [61, 300, 600]), (1, 1650, [700, 1200, 1650]),
                          (1, 656, [258, 400, 656]), (1, 947, [558, 888, 947])):
        for dtype in (torch.float32, torch.bfloat16):
            check(B, S, dtype, lengths)
    log(f"decode_attention: {n_checks} cases agree with the plain version, each called twice "
        f"with bit-identical results; max abs err fp32 {worst[torch.float32]:.3g} (tol 1e-5), "
        f"bf16 {worst[torch.bfloat16]:.3g} (tol 1e-3)")

    # timing: 32 caches, one per layer as in the model (more bytes than the
    # 50 MB L2 holds at B=1), so each call reads its cache from device memory
    times = {}
    shapes = [(B, dtype, 685, 685) for B in (1, 4) for dtype in (torch.bfloat16, torch.float32)]
    shapes += [(1, torch.bfloat16, 720, 95), (1, torch.bfloat16, 720, 300)]
    shapes += [(16, dtype, 600, 600) for dtype in (torch.bfloat16, torch.float32)]
    shapes += [(1, dtype, 1650, 1650) for dtype in (torch.bfloat16, torch.float32)]
    shapes += [(1, dtype, S, S) for S in (656, 947) for dtype in (torch.bfloat16, torch.float32)]
    for B, dtype, S, n in shapes:
        q = torch.randn(B, H, DH, generator=gen, device=dev).to(dtype)
        caches = [(torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype),
                   torch.randn(B, S, H, DH, generator=gen, device=dev).to(dtype))
                  for _ in range(32)]
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        kern = [lambda k=k, v=v: decode_attention(q, k, v, n) for k, v in caches]
        plain = [lambda k=k, v=v: decode_attention_torch(q, k, v, lens) for k, v in caches]
        # the library yardstick: q as [B, H, 1, dh], the caches as [B, H, S, dh]
        # views, a [B, 1, 1, S] mask made here, outside the timed calls
        mask = (torch.arange(S, device=dev) < n)[None, None, None, :].expand(B, 1, 1, S)
        lib = [lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)
            for k, v in caches]
        lib_out = lib[0]()[:, :, 0].float()
        lib_err = (lib_out - decode_attention_torch(q.float(), caches[0][0].float(),
                                                    caches[0][1].float(), n)).abs().max().item()
        t = {"kernel": time_device(kern), "plain": time_device(plain), "library": time_device(lib)}
        t["kernel2"] = time_device(kern)
        t["kernel_call"] = time_host(kern[0])
        t["plain_call"] = time_host(plain[0])
        bound, bound_by, nbytes = attention_bound_ms(B, n, dtype)
        t.update(bound=bound, bound_by=bound_by, bytes=nbytes)
        times[(B, dtype, S, n)] = t
        splits, chunk = split_plan(B, H, S, n, sms)
        log(f"decode_attention {str(dtype)[6:]} B={B} S={S} n={n} ({splits} splits of {chunk} "
            f"keys, {splits * B * H} blocks): device {t['kernel'] * 1e3:.2f} / "
            f"{t['kernel2'] * 1e3:.2f} us kernel, {t['plain'] * 1e3:.2f} us plain, "
            f"{t['library'] * 1e3:.2f} us library (SDPA, max abs diff {lib_err:.2g}); "
            f"bound {bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, {bound_by}): "
            f"{100 * bound / t['kernel']:.1f} % of bound, {nbytes / t['kernel'] / 1e9:.3f} TB/s; "
            f"per call with launch {t['kernel_call'] * 1e3:.2f} us kernel, "
            f"{t['plain_call'] * 1e3:.2f} us plain | {card}")
    # the split plan against other split counts, at the main path's shape
    q = torch.randn(1, H, DH, generator=gen, device=dev).to(torch.bfloat16)
    caches = [(torch.randn(1, 685, H, DH, generator=gen, device=dev).to(torch.bfloat16),
               torch.randn(1, 685, H, DH, generator=gen, device=dev).to(torch.bfloat16))
              for _ in range(32)]
    fns = [lambda k=k, v=v: decode_attention(q, k, v, 685) for k, v in caches]
    planned = split_plan(1, H, 685, 685, sms)[0]
    plan_us = {}
    for splits in sorted({planned, 1, 6, 9, 16}):
        with forced_splits(685, splits):
            plan_us[splits] = time_device(fns) * 1e3
    log(f"decode_attention split plan on {sms} SMs, bf16 B=1 n=685, device us by split count "
        f"(blocks = 16 x splits): " + ", ".join(f"{s}{' (plan)' if s == planned else ''} "
                                                f"{us:.2f}" for s, us in plan_us.items())
        + f" | {card}")

    t = times[(1, torch.bfloat16, 685, 685)]
    return {
        "name": "decode_attention",
        "route": "cuda",
        "source": "tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "tts_tpu/ops/pallas_attention.py:52",
        "max_abs_err": max(worst.values()),
        "ms": t["kernel"],
        "plain_ms": t["plain"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "library_ms": t["library"],
        "tb_per_s": t["bytes"] / t["kernel"] / 1e9,
    }


def phase_slice(card: str, device="cuda", config=None):
    """Full-width XTTS v2 (``config`` defaults to ``XttsConfig()``), greedy
    40-token decode through the kernel and through the plain attention;
    then the bf16 decode step timed."""
    import torch

    from tts_tpu_torch.models.xtts.config import XttsConfig
    from tts_tpu_torch.models.xtts.model import Xtts
    from tts_tpu_torch.ops.decode_attention import decode_attention

    t0 = time.time()
    with built_on(device):
        model = Xtts(config or XttsConfig())
    model.init_params(seed=0, device=device, dtype=torch.float32)
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = len(model.gpt.gpt.h)
    log(f"XTTS v2: {n_layers} layers, width {model.args.gpt_n_model_channels}, "
        f"{model.args.gpt_n_heads} heads, {n_params / 1e6:.1f} M parameters "
        f"(random, seed 0), ready in {time.time() - t0:.1f} s")

    wav = reference_wav()
    cond = model.get_gpt_cond_latents(wav, 22050, chunk_length=4)
    spk = model.get_speaker_embedding(wav, 22050)
    if cond.shape != (1, 32, model.args.gpt_n_model_channels) or spk.shape != (1, 512):
        raise AssertionError(f"conditioning shapes {tuple(cond.shape)}, {tuple(spk.shape)}")
    if not (torch.isfinite(cond).all() and torch.isfinite(spk).all()):
        raise AssertionError("conditioning is not finite")

    n_text = min(200, model.args.gpt_number_text_tokens)
    text = torch.from_numpy(np.random.RandomState(0).randint(5, n_text, (1, 40))).to(device)
    lengths = torch.tensor([40], device=device)
    kw = dict(max_new_tokens=40, temperature=0.75, top_k=1, top_p=0.85, repetition_penalty=5.0)

    before = decode_attention.launches
    with_kernel = model.gpt.generate(cond, text, lengths, None, **kw)
    sync(device)
    if device == "cuda" and decode_attention.launches - before != n_layers * 40:
        raise AssertionError(f"{decode_attention.launches - before} kernel launches, "
                             f"want {n_layers * 40}")
    with plain_decode_attention():
        with_plain = model.gpt.generate(cond, text, lengths, None, **kw)
    sync(device)
    if device == "cuda" and decode_attention.launches - before != n_layers * 40:
        raise AssertionError("the plain run launched the kernel")
    if not torch.equal(with_kernel["codes"], with_plain["codes"]):
        raise AssertionError(f"tokens differ:\n{with_kernel['codes']}\n{with_plain['codes']}")
    lat_err = (with_kernel["latents"] - with_plain["latents"]).abs().max().item()
    if not lat_err <= 1e-4:
        raise AssertionError(f"latents differ by {lat_err} > 1e-4")
    audio = model.hifigan_decoder(with_kernel["latents"], spk)
    # 40 codes → 160 frames → int(160 · 24000/22050) = 174 frames → × 256 samples
    if audio.shape != (1, int(160 * 24000 / 22050) * 256, 1):
        raise AssertionError(f"decoder output shape {tuple(audio.shape)}")
    if not torch.isfinite(audio).all():
        raise AssertionError("decoder output is not finite")
    log(f"slice: 40 greedy tokens identical through kernel and plain attention, latents "
        f"max abs diff {lat_err:.3g} (tol 1e-4); {audio.shape[1]} samples of finite audio, "
        f"peak {audio.abs().max().item():.3f}")

    # decode step time in the serving dtype (bf16 GPT), kernel vs plain
    model.gpt.to(torch.bfloat16)
    for B in (1, 4):
        step_ms = {}
        for name in ("kernel", "plain", "kernel "):
            ctx = plain_decode_attention() if name == "plain" else contextlib.nullcontext()
            with ctx:
                state = model.gpt.prefill(cond.expand(B, -1, -1), text.expand(B, -1),
                                          lengths.expand(B), max_new_tokens=120)
                state, _, _ = model.gpt.decode_chunk(state, None, chunk_size=20, top_k=1)
                sync(device)
                t1 = time.perf_counter()
                model.gpt.decode_chunk(state, None, chunk_size=100, top_k=1)
                sync(device)
                step_ms[name] = (time.perf_counter() - t1) * 1e3 / 100
        log(f"decode step, bf16 GPT, B={B}, cache ~{state['cur_index']}: "
            f"{step_ms['kernel']:.2f} / {step_ms['kernel ']:.2f} ms kernel, "
            f"{step_ms['plain']:.2f} ms plain attention (host clock, synchronized) | {card}")
    profile_decode(model, cond, text, lengths, card, device)
    return model


def log_profile(prof, what: str, wall_us: float, card: str, top: int = 6) -> None:
    """Device busy share and top kernels of a profiled window. Only the
    kernel rows count: an operator's row repeats the device time of the
    kernels it launched. The windows record device activity alone (no CPU
    operator rows): the profiler takes ~0.2 ms a kernel to digest, and
    about twice that with every operator recorded beside it."""
    from torch.autograd import DeviceType

    rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    if not rows:
        log(f"profile, {what}: the profiler reported no device time (busy share not measured)")
        return None
    busy_us = sum(e.self_device_time_total for e in rows)
    all_rows_us = sum(e.self_device_time_total for e in prof.key_averages())
    others = (f"; all rows {all_rows_us / 1e3:.2f} ms" if all_rows_us > busy_us * (1 + 1e-6)
              else "")
    log(f"profile, {what}: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
        f"({100 * busy_us / wall_us:.1f} % busy; {sum(e.count for e in rows)} kernels{others}) "
        f"| {card}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x  {e.key[:90]}")
    return busy_us / wall_us


def profile_decode(model, cond, text, lengths, card: str, device="cuda") -> None:
    """Device busy share of a bf16 B=1 decode chunk, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    state = model.gpt.prefill(cond, text, lengths, max_new_tokens=60)
    model.gpt.decode_chunk(state, None, chunk_size=20, top_k=1)
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        model.gpt.decode_chunk(state, None, chunk_size=20, top_k=1)
        sync(device)
        wall_us = (time.perf_counter() - t1) * 1e6
    log_profile(prof, "bf16 B=1, 20 decode steps", wall_us, card)


def ttfa_parts(model, wav_path: str, text: str, device) -> dict:
    """Milliseconds of each stage before a stream's first audio, one stream
    on an idle device (host clock, synchronized)."""
    import torch

    parts = {}

    def timed(name, fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    cond, spk = timed("conditioning",
                      lambda: model.resolve_conditioning(model.config, speaker_wav=wav_path))
    tokens, lengths = model._text_batch([text], "en")
    state = timed("prefill", lambda: model.gpt.prefill(cond, tokens, lengths,
                                                       max_new_tokens=STREAM_CHUNK))
    _, _, latents = timed("decode", lambda: model.gpt.decode_chunk(
        state, None, chunk_size=STREAM_CHUNK, top_k=1))
    audio = timed("vocoder", lambda: model.hifigan_decoder(latents, spk))
    if not torch.isfinite(audio).all():
        raise AssertionError("vocoder output is not finite")
    return parts


def _fetch(url: str, out: dict, key: str) -> None:
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=900) as r:
        status = r.status
        head = r.read(44)
        first = r.read(2)  # blocks until the first audio bytes
        ttfa = time.perf_counter() - t0
        body = head + first + r.read()
    out[key] = {"status": status, "body": body, "ttfa": ttfa, "total": time.perf_counter() - t0}


def xtts_cli_call(model_dir: str, text: str, n_layers: int, card: str, device="cuda") -> None:
    """One ``tts`` command-line call on the XTTS model directory, cloning its
    reference voice into a file: a new model loads and decodes to the token
    limit (the stop token is suppressed). The decode-attention launches of
    the call must be ``n_layers`` x its decode steps, counted by the GPT of
    the model the command line built."""
    import scipy.io.wavfile

    import tts_tpu_torch.api as api
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.ops.decode_attention import decode_attention

    built = []

    class RecordedTTS(api.TTS):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    out = os.path.join(model_dir, "cli.wav")
    real, api.TTS = api.TTS, RecordedTTS
    try:
        decode_attention.launches = 0
        t0 = time.perf_counter()
        synthesize_cli(["--text", text, "--model_path", model_dir, "--speaker_wav",
                        os.path.join(model_dir, "ref.wav"), "--language_idx", "en",
                        "--out_path", out, "--device", str(device)])
        sync(device)
        seconds = time.perf_counter() - t0
        launches = decode_attention.launches
    finally:
        api.TTS = real
    steps = built[0].synthesizer.tts_model.gpt.decode_steps
    sr, pcm = scipy.io.wavfile.read(out)
    if sr != 24000 or len(pcm) < STREAM_CHUNK * 1024 or pcm.std() < 30:
        raise AssertionError(f"tts command line (XTTS): {len(pcm)} samples at {sr} Hz, "
                             f"std {pcm.std():.1f}")
    if steps == 0 or (device == "cuda" and launches != n_layers * steps):
        raise AssertionError(f"tts command line (XTTS): decode_attention launched {launches} "
                             f"times for {steps} decode steps of {n_layers} layers")
    log(f"tts command line (XTTS, --speaker_wav, --language_idx en): {len(pcm) / sr:.1f} s of "
        f"audio in {seconds:.2f} s including the model's load; {steps} decode steps, "
        f"decode_attention launches {launches} = {n_layers} x {steps} | {card}")


def phase_serving(model, card: str, device="cuda") -> int:
    """Serve 4 concurrent streams and one full request through the port's
    HTTP server; returns the decode-attention launches of this phase."""
    import io

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.audio.numpy_transforms import save_wav
    from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args

    texts = ["the quick brown fox jumps over the lazy dog.",
             "a port of a streaming voice model to one card.",
             "four voices speak at once through one batch.",
             "each request gets its own stream of audio."]
    full_text = "this request waits for the whole utterance."
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(model.config.to_dict(), f, default=str)
        write_char_vocab(os.path.join(d, "vocab.json"), "abcdefghijklmnopqrstuvwxyz.,!?'-")
        # random weights sample the stop token now and then; forbid it so
        # every stream decodes its full length and the checks are exact
        model.gpt.mel_head.bias[model.gpt.stop_audio_token] = -1e4
        torch.save(model.state_dict_with_stats(), os.path.join(d, "model_torch.pt"))
        save_wav(wav=reference_wav(seed=1), path=os.path.join(d, "ref.wav"), sample_rate=22050)

        args = build_parser().parse_args(
            ["--model_path", d, "--port", "0", "--stream_batch", "4", "--stream_window_ms", "300",
             "--device", str(device)]
        )
        srv = server_from_args(args)
        served = srv.stream_batcher.model
        if served.gpt.dtype != torch.bfloat16:
            raise AssertionError(f"served GPT dtype {served.gpt.dtype}, want bf16")
        n_layers = len(served.gpt.gpt.h)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        ref = urllib.parse.quote(os.path.join(d, "ref.wav"))
        urls = {t: f"{base}/api/tts-stream?text={urllib.parse.quote(t)}&language_id=en"
                   f"&speaker_wav={ref}" for t in texts}
        urls["full"] = f"{base}/api/tts?text={urllib.parse.quote(full_text)}&language_id=en" \
                       f"&speaker_wav={ref}"
        results: dict = {}
        cuda = torch.device(device).type == "cuda"
        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            decode_attention.launches = 0
            served.gpt.decode_steps = served.gpt.decode_tokens = 0
            t0 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(u, results, k)) for k, u in urls.items()]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=900)
            elapsed = time.perf_counter() - t0
            launches, steps = decode_attention.launches, served.gpt.decode_steps
            tokens = served.gpt.decode_tokens
            peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
            if any(c.is_alive() for c in clients) or set(results) != set(urls):
                raise AssertionError(f"requests unanswered: {sorted(set(urls) - set(results))}")
            # then one stream alone on the idle server: its time to first audio
            # is conditioning + batching window + prefill + one chunk + vocoder
            _fetch(urls[texts[0]], results, "alone")
            # one more chunk straight from the model: the float audio is finite
            cond, spk = served.resolve_conditioning(served.config,
                                                    speaker_wav=os.path.join(d, "ref.wav"))
            probe = next(iter(served.inference_stream(texts[0], "en", cond, spk,
                                                      max_new_tokens=STREAM_CHUNK)))
            parts = ttfa_parts(served, os.path.join(d, "ref.wav"), texts[0], device)
        finally:
            close_server(srv)
            thread.join(timeout=60)
        xtts_cli_call(d, texts[0], n_layers, card, device)

    sr = served.config.model_args.output_sample_rate
    min_samples = STREAM_CHUNK * 1024
    for key, res in results.items():
        body = res["body"]
        if res["status"] != 200 or body[:4] != b"RIFF":
            raise AssertionError(f"{key!r}: HTTP {res['status']}, body starts {body[:4]!r}")
        if key == "full":
            _, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        else:
            pcm = np.frombuffer(body[44:], dtype="<i2")
        if len(pcm) < min_samples:
            raise AssertionError(f"{key!r}: {len(pcm)} samples, want >= {min_samples}")
        if np.count_nonzero(pcm) < len(pcm) // 2 or pcm.std() < 30:
            raise AssertionError(f"{key!r}: silent audio (std {pcm.std():.1f} of 32767)")
        res["seconds"] = len(pcm) / sr
    if not np.isfinite(probe).all() or len(probe) < min_samples:
        raise AssertionError("direct streaming chunk is not finite or too short")
    if steps == 0 or (device == "cuda" and launches != n_layers * steps):
        raise AssertionError(
            f"decode_attention launched {launches} times for {steps} decode steps of "
            f"{n_layers} layers ({tokens} tokens)"
        )
    # every request decodes to the bound of every decode, max_mel_tokens - 3
    # tokens: a stream's last chunk is cut short there (ROADMAP.md F5)
    max_new = served.gpt.max_mel_tokens - 3
    if tokens != len(urls) * max_new:
        raise AssertionError(f"{tokens} tokens decoded for {len(urls)} requests, want "
                             f"{len(urls)} x {max_new}")
    ttfa = sorted(results[t]["ttfa"] for t in texts)
    audio_s = sum(r["seconds"] for k, r in results.items() if k != "alone")
    log(f"serving: {len(texts)} concurrent /api/tts-stream + 1 /api/tts, {audio_s:.1f} s of "
        f"audio in {elapsed:.2f} s; {steps} decode steps, {tokens} tokens = {len(urls)} x "
        f"{max_new}, decode_attention launches {launches} = {n_layers} x {steps}")
    log(f"serving: TTFA median {ttfa[len(ttfa) // 2] * 1e3:.0f} ms, max {ttfa[-1] * 1e3:.0f} ms "
        f"under load, {results['alone']['ttfa'] * 1e3:.0f} ms alone (300 ms batching window "
        f"included); aggregate decode {tokens / elapsed:.1f} tokens/s; /api/tts "
        f"{results['full']['total']:.2f} s for {results['full']['seconds']:.1f} s of audio; "
        f"peak device memory {peak_gb:.2f} GB | {card}")
    log("serving: TTFA parts, one stream on an idle device: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items())
        + f" (host clock, synchronized; bf16 GPT, {STREAM_CHUNK} decode steps) | {card}")
    return launches


# ---------------------------------------------------------------------------
VITS_SENTENCES = {
    "short": "Be a voice, not an echo.",
    "medium": "It took me quite a long time to develop a voice, and now that I have it "
              "I'm not going to be silent.",
    "long": "The Commission has not been able to find any credible evidence that the "
            "assassin had any help in planning or carrying out the shooting. On November "
            "22, 1963, at 12:30 p.m., the motorcade turned onto Elm Street, and within "
            "seconds three shots had been fired from the sixth floor of the depository.",
}
VITS_WAV_TOL = 1e-4  # card vs CPU, fp32 with TF32 off


def vits_recipe_config():
    """``recipes/ljspeech/vits/train_vits.py``'s inference fields (its
    ``add_blank`` is ``VitsConfig``'s default) at the ``VitsArgs`` defaults.
    ``num_chars`` is left to the tokenizer, which sizes the embedding to the
    131 IPA symbols as the reference's VITS does (the default 100 would
    leave the punctuation ids past the table, ROADMAP.md F7)."""
    from tts_tpu_torch.models.vits import VitsConfig

    config = VitsConfig(text_cleaner="english_cleaners", use_phonemes=True,
                        phoneme_language="en-us")
    config.model_args.num_chars = None
    return config


@contextlib.contextmanager
def host_noise(seed: int = 0):
    """Every VITS noise draw comes from one table on the host, keyed by
    shape and drawn on first use from a CPU generator, then copied to the
    generator's device: a card run and a CPU run get the same noise, and a
    durations pass gets the draw of the inference after it."""
    import torch

    from tts_tpu_torch.models.vits import modules

    gen = torch.Generator().manual_seed(seed)
    table = {}

    def normal(shape, generator):
        key = tuple(shape)
        if key not in table:
            table[key] = torch.randn(key, generator=gen)
        return table[key].to(generator.device)

    real = modules.normal
    modules.normal = normal
    try:
        yield
    finally:
        modules.normal = real


def hifigan_gflop(args, frames: int) -> float:
    """Operations (2 per multiply-add) of VITS's HiFiGAN decoder for
    ``frames`` latent frames: ``conv_pre``, each transposed conv (every
    input frame meets ``k`` taps), each ResBlock1's two convs per dilation
    at the upsampled rate, and ``conv_post``."""
    ch = args.upsample_initial_channel_decoder
    flops = 2 * args.hidden_channels * ch * 7 * frames
    n = frames
    for i, (u, k) in enumerate(zip(args.upsample_rates_decoder,
                                   args.upsample_kernel_sizes_decoder)):
        cin, cout = ch // 2**i, ch // 2 ** (i + 1)
        flops += 2 * cin * cout * k * n
        n *= u
        for kr, dils in zip(args.resblock_kernel_sizes_decoder,
                            args.resblock_dilation_sizes_decoder):
            flops += 2 * len(dils) * 2 * cout * cout * kr * n
    flops += 2 * cout * 7 * n
    return flops / 1e9


def vits_stage_ms(model, text: str, device, reps: int = 5) -> dict:
    """Milliseconds of each stage of one sentence's inference on the card
    (host clock around synchronized calls, median of ``reps``), and of the
    whole ``synthesis`` call."""
    import torch

    from tts_tpu_torch.ops.helpers import generate_path, sequence_mask
    from tts_tpu_torch.utils.synthesis import synthesis

    vm = model.module
    a = model.args
    ids = model.tokenizer.text_to_ids(text)
    T = ((len(ids) + 15) // 16) * 16
    x = torch.zeros(1, T, dtype=torch.long, device=device)
    x[0, : len(ids)] = torch.tensor(ids, device=device)
    xl = torch.tensor([len(ids)], device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    times: dict = {}

    def timed(name, fn):
        runs = []
        for _ in range(reps):
            sync(device)
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            runs.append((time.perf_counter() - t0) * 1e3)
        times[name] = sorted(runs)[reps // 2]
        return out

    with torch.no_grad():
        h, m_p, logs_p, x_mask = timed("text encoder", lambda: vm.text_encoder(x, xl))
        logw = timed("duration predictor", lambda: vm.duration_predictor(
            h, x_mask, gen.manual_seed(0), noise_scale=a.inference_noise_scale_dp))
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * a.length_scale) * x_mask
        frames = int(w_ceil.sum())
        budget = ((frames + 31) // 32) * 32

        def expand():
            y_mask = sequence_mask(torch.tensor([frames], device=device), budget)[:, :, None]
            attn = generate_path(w_ceil[:, :, 0], x_mask * y_mask.transpose(1, 2).float())
            m = torch.bmm(attn.transpose(1, 2), m_p)
            lg = torch.bmm(attn.transpose(1, 2), logs_p)
            noise = torch.randn(m.shape, generator=gen, device=device)
            return (m + noise * torch.exp(lg) * a.inference_noise_scale), y_mask.float()

        z_p, y_mask = timed("path + prior", expand)
        z = timed("flow", lambda: vm.flow(z_p * y_mask, y_mask))
        timed("HiFiGAN", lambda: vm.waveform_decoder(z * y_mask))
        # the decoder alone, device-bound: CUDA events around 10 calls
        hifigan_ms = time_host(lambda: vm.waveform_decoder(z * y_mask), iters=10,
                               warmup=2) if torch.device(device).type == "cuda" else None
    timed("synthesis (all, incl. durations pass)", lambda: synthesis(model, text))
    return {"times": times, "frames": frames, "budget": budget, "tokens": len(ids),
            "hifigan_ms": hifigan_ms}


def profile_vits(model, text: str, card: str) -> None:
    """Device busy share of one ``synthesis`` call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.utils.synthesis import synthesis

    synthesis(model, text)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        synthesis(model, text)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    log_profile(prof, "VITS, one medium sentence through synthesis()", wall_us, card, top=8)


def _http(url: str, data: bytes = None) -> tuple:
    """``(status, content type, body)`` of one request; ``data`` makes it a
    POST of a form body."""
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=600) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def check_vits_routes(routes: dict, short_tts_body: bytes) -> None:
    """``/details`` names the recipe's model and phoneme language, the
    MaryTTS routes answer as the JAX server does, and ``POST /process``
    gives a wav of ``/api/tts``'s length for the same text."""
    import io

    import scipy.io.wavfile

    status, ctype, body = routes["/details"]
    details = json.loads(body) if status == 200 else {}
    config = details.get("tts_config") or {}
    if (ctype, config.get("model"), config.get("phoneme_language")) != (
            "application/json", "vits", "en-us") or details.get("speakers") != []:
        raise AssertionError(f"/details: HTTP {status} {ctype}, model {config.get('model')!r}, "
                             f"phoneme_language {config.get('phoneme_language')!r}")
    for path, want in (("/locales", b"en_US\n"), ("/voices", b"default en_US u\n")):
        if routes[path] != (200, "text/plain", want):
            raise AssertionError(f"{path}: {routes[path]!r}")
    status, ctype, body = routes["POST /process"]
    want = scipy.io.wavfile.read(io.BytesIO(short_tts_body))[1]
    if status != 200 or ctype != "audio/wav":
        raise AssertionError(f"POST /process: HTTP {status} {ctype}")
    got = scipy.io.wavfile.read(io.BytesIO(body))[1]
    if got.shape != want.shape or got.std() < 30:
        raise AssertionError(f"POST /process: {got.shape} samples, /api/tts {want.shape}")
    log(f"VITS routes: /details (model vits, phoneme_language en-us), /locales, /voices as the "
        f"JAX server; POST /process {len(got)} samples = /api/tts's")


def phase_vits(card: str, device="cuda", config=None) -> dict:
    """Full-width single-speaker VITS on the card: card against CPU on three
    sentences, three served ``/api/tts`` requests, one file through the API,
    then RTF, stage times, busy share and peak memory. Returns each
    sentence's median latency in ms."""
    import io

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.synthesis import synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP

    cuda = torch.device(device).type == "cuda"
    config = config or vits_recipe_config()
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()  # what earlier phases left in reference cycles (their server)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    t0 = time.time()
    model = Vits.init_from_config(config).init_params(seed=0, device=device)
    a = model.args
    n_params = sum(p.numel() for p in model.module.parameters())
    tokens = {k: len(model.tokenizer.text_to_ids(t)) for k, t in VITS_SENTENCES.items()}
    log(f"VITS text front end: {config.text_cleaner}, phonemizer "
        f"{model.tokenizer.phonemizer.name()} ({config.phoneme_language}), "
        f"{type(model.tokenizer.characters).__name__} with num_chars {a.num_chars}, blanks "
        f"{config.add_blank}; token counts " + ", ".join(f"{k} {n}" for k, n in tokens.items()))
    log(f"VITS (LJSpeech recipe, phonemes): hidden {a.hidden_channels}, FFN "
        f"{a.hidden_channels_ffn_text_encoder}, {a.num_layers_text_encoder} encoder layers, "
        f"{a.num_heads_text_encoder} heads, 4 flows of {a.num_layers_flow} WN layers, "
        f"stochastic durations, HiFiGAN {a.upsample_initial_channel_decoder} ch x "
        f"{a.upsample_rates_decoder}; {n_params / 1e6:.2f} M parameters (random, seed 0), "
        f"ready in {time.time() - t0:.1f} s")

    # card against CPU: same weights (drawn on the host), same host noise
    texts = list(VITS_SENTENCES.values())
    cpu_model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
    worst, lengths = 0.0, []
    with host_noise(seed=0):
        for text in texts:
            got = synthesis(model, text)
            want = synthesis(cpu_model, text)
            g_len, w_len = got["outputs"]["y_lengths"].cpu(), want["outputs"]["y_lengths"]
            if not torch.equal(g_len, w_len):
                raise AssertionError(f"VITS y_lengths card {g_len.tolist()} != CPU "
                                     f"{w_len.tolist()} for {text!r}")
            if got["wav"].shape != want["wav"].shape or not np.isfinite(got["wav"]).all():
                raise AssertionError(f"VITS waveform {got['wav'].shape} vs {want['wav'].shape}")
            err = float(np.abs(got["wav"] - want["wav"]).max())
            worst = max(worst, err)
            lengths.append(int(g_len[0]))
            if not err <= VITS_WAV_TOL:
                raise AssertionError(f"VITS card vs CPU: max abs diff {err} > {VITS_WAV_TOL} "
                                     f"for {text!r}")
    del cpu_model
    log(f"VITS card vs CPU, three sentences on host noise: y_lengths {lengths} equal, "
        f"waveform max abs diff {worst:.3g} (tol {VITS_WAV_TOL})")

    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(model.config.to_dict(), f)
        torch.save(model.module.state_dict(), os.path.join(d, "model_torch.pt"))
        # three concurrent /api/tts requests through the server's command line
        args = build_parser().parse_args(["--model_path", d, "--port", "0",
                                          "--device", str(device)])
        srv = server_from_args(args)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        results: dict = {}
        try:
            t1 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(
                f"{base}/api/tts?text={urllib.parse.quote(t)}", results, k))
                for k, t in VITS_SENTENCES.items()]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            served_s = time.perf_counter() - t1
            routes = {path: _http(base + path) for path in ("/details", "/locales", "/voices")}
            form = urllib.parse.urlencode({"INPUT_TEXT": VITS_SENTENCES["short"]}).encode()
            routes["POST /process"] = _http(base + "/process", data=form)
        finally:
            close_server(srv)
            thread.join(timeout=60)
        if set(results) != set(VITS_SENTENCES):
            raise AssertionError(f"VITS requests unanswered: "
                                 f"{sorted(set(VITS_SENTENCES) - set(results))}")
        audio_s = 0.0
        for key, res in results.items():
            body = res["body"]
            if res["status"] != 200 or body[:4] != b"RIFF":
                raise AssertionError(f"VITS /api/tts {key!r}: HTTP {res['status']}")
            sr, pcm = scipy.io.wavfile.read(io.BytesIO(body))
            if sr != 22050 or len(pcm) <= SENTENCE_GAP or pcm[:-SENTENCE_GAP].std() < 30:
                raise AssertionError(f"VITS /api/tts {key!r}: {sr} Hz, {len(pcm)} samples")
            audio_s += len(pcm) / sr
        log(f"VITS serving: 3 concurrent /api/tts requests, {audio_s:.2f} s of audio in "
            f"{served_s:.2f} s (one lock: served one after another) | {card}")
        check_vits_routes(routes, results["short"]["body"])

        # one file through the API, one through the command line: same noise
        # (each call seeds its generator), same samples
        tts = TTS(model_path=d, device=device)
        path = tts.tts_to_file(VITS_SENTENCES["medium"], file_path=os.path.join(d, "api.wav"))
        sr, pcm = scipy.io.wavfile.read(path)
        if sr != 22050 or len(pcm) <= SENTENCE_GAP:
            raise AssertionError(f"TTS.tts_to_file wrote {len(pcm)} samples at {sr} Hz")
        del tts
        cli_path = os.path.join(d, "cli.wav")
        synthesize_cli(["--text", VITS_SENTENCES["medium"], "--model_path", d,
                        "--out_path", cli_path, "--device", str(device)])
        cli_sr, cli_pcm = scipy.io.wavfile.read(cli_path)
        step = np.abs(cli_pcm.astype(np.int32) - pcm.astype(np.int32)).max()
        if cli_sr != sr or cli_pcm.shape != pcm.shape or pcm.dtype != np.int16 or step > 1:
            raise AssertionError(f"tts command line {cli_pcm.shape} {cli_pcm.dtype} at {cli_sr} Hz "
                                 f"vs TTS.tts_to_file {pcm.shape} {pcm.dtype}: {step} int16 steps")
        log(f"VITS TTS.tts_to_file and the tts command line: {len(pcm)} 16-bit samples at {sr} Hz "
            f"each, at most {step} int16 step apart")

    # real-time factor at B=1: audio seconds per wall second, median of 5
    synthesis(model, VITS_SENTENCES["medium"])
    sync(device)
    latency_ms = {}
    for key, text in VITS_SENTENCES.items():
        runs = []
        for _ in range(5):
            sync(device)
            t1 = time.perf_counter()
            out = synthesis(model, text)
            sync(device)
            runs.append(time.perf_counter() - t1)
        wall = sorted(runs)[2]
        latency_ms[key] = wall * 1e3
        seconds = len(out["wav"]) / 22050
        log(f"VITS RTF {key}: {seconds:.2f} s of audio ({int(out['outputs']['y_lengths'][0])} "
            f"frames, {out['text_inputs'].shape[1]} padded tokens) in {wall * 1e3:.1f} ms "
            f"(median of 5; {min(runs) * 1e3:.1f}-{max(runs) * 1e3:.1f}), RTF "
            f"{seconds / wall:.1f} x real time | {card}")
    stages = vits_stage_ms(model, VITS_SENTENCES["medium"], device)
    log(f"VITS stages, medium sentence ({stages['tokens']} tokens, {stages['frames']} frames, "
        f"budget {stages['budget']}), ms (host clock, synchronized, median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages["times"].items()) + f" | {card}")
    gflop = hifigan_gflop(model.args, stages["budget"])
    per_s = hifigan_gflop(model.args, 1) * model.config.audio.sample_rate / model.hop_length
    line = (f"VITS HiFiGAN: {gflop:.1f} GFLOP for the {stages['budget']}-frame budget "
            f"({per_s:.2f} GFLOP per second of audio); fp32 bound "
            f"{gflop / FP32_FLOPS_PER_S * 1e12:.2f} ms at 67 TFLOP/s")
    if stages["hifigan_ms"] is not None:
        ms = stages["hifigan_ms"]
        line += (f"; {ms:.2f} ms per call (CUDA events, 10 calls), {gflop / ms:.1f} TFLOP/s, "
                 f"{100 * gflop / ms * 1e12 / FP32_FLOPS_PER_S:.1f} % of the fp32 peak")
    log(line + f" | {card}")
    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the VITS phase")
    log("VITS: no hand-written kernel on this path (decode_attention launches 0)")
    if cuda:
        profile_vits(model, VITS_SENTENCES["medium"], card)
        peak = torch.cuda.max_memory_allocated()
        log(f"VITS peak device memory {peak / 1e9:.3f} GB allocated, {(peak - resident) / 1e9:.3f} "
            f"GB above the {resident / 1e9:.3f} GB resident before the phase | {card}")
    return latency_ms


# ---------------------------------------------------------------------------
VITS_MASKED_TOL = 1e-4  # packed segment vs its own masked decode, both on the card
# the serving mix: requests by sentence length, as (key, count); "long" is two sentences
VITS_MIX = (("short", 2), ("medium", 4), ("long", 2))


def vits_request() -> str:
    """Three sentences of phase 6's: the short, the medium, and the long
    one's first."""
    from tts_tpu_torch.utils.synthesizer import split_into_sentences

    first = split_into_sentences(VITS_SENTENCES["long"])[0]
    return " ".join([VITS_SENTENCES["short"], VITS_SENTENCES["medium"], first])


@contextlib.contextmanager
def recorded_plans():
    """Every pack plan ``decode_packed`` makes inside, in order."""
    from tts_tpu_torch.utils import synthesis as synthesis_module

    plans = []
    real = synthesis_module.plan_pack_layout

    def recording(*args, **kwargs):
        plans.append(real(*args, **kwargs))
        return plans[-1]

    synthesis_module.plan_pack_layout = recording
    try:
        yield plans
    finally:
        synthesis_module.plan_pack_layout = real


@contextlib.contextmanager
def recorded_y_lengths(model, methods=("inference_packed",)):
    """``y_lengths`` of every call of ``model``'s ``methods`` inside."""
    seen = []

    def recording(real):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            seen.append(out["y_lengths"].cpu().tolist())
            return out
        return call

    for name in methods:
        setattr(model, name, recording(getattr(model, name)))
    try:
        yield seen
    finally:
        for name in methods:
            delattr(model, name)


def padded_ids(model, sentences, rows: int):
    """Token ids of ``sentences`` in ``rows`` rows (rows past them length
    1), padded to a multiple of 16: ``(x, x_lengths)`` on the model's
    device, as the batcher pads them."""
    import torch

    ids = [model.tokenizer.text_to_ids(s) for s in sentences]
    width = ((max(len(i) for i in ids) + 15) // 16) * 16
    x = torch.zeros(rows, width, dtype=torch.long)
    x_lengths = torch.ones(rows, dtype=torch.long)
    for row, i in enumerate(ids):
        x[row, : len(i)] = torch.tensor(i)
        x_lengths[row] = len(i)
    return x.to(model.device), x_lengths.to(model.device)


def masked_decodes(model, x, x_lengths, noise_frames: int, aux=None) -> list:
    """Each row of ``x`` decoded alone at its own length, with its own
    speaker from ``aux`` (``aux_input``), zero-padded by 16 frames and
    masked after every layer and conv, on the noise
    ``inference_packed(noise_layout="batch")`` draws from a generator seeded
    0 on the model's device: the reference each packed segment must equal."""
    import torch

    from tts_tpu_torch.models.vits import modules
    from tts_tpu_torch.ops.helpers import generate_path, sequence_mask

    vm, a, dev = model.module, model.args, model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    wavs = []
    with torch.no_grad():
        g, lang = vm._cond_vectors(aux)
        w_ceil, m_p, logs_p, x_mask = vm._durations(x, x_lengths, gen, g, lang)
        noise = modules.normal((x.shape[0], noise_frames, m_p.shape[-1]), gen)
        for i in range(x.shape[0]):
            frames = int(w_ceil[i].sum())
            y_mask = sequence_mask(torch.tensor([frames], device=dev),
                                   frames + 16)[:, :, None].float()
            attn = generate_path(w_ceil[i : i + 1, :, 0],
                                 x_mask[i : i + 1] * y_mask.transpose(1, 2))
            mean = torch.bmm(attn.transpose(1, 2), m_p[i : i + 1])
            log_scale = torch.bmm(attn.transpose(1, 2), logs_p[i : i + 1])
            eps = torch.zeros_like(mean)
            eps[0, :frames] = noise[i, :frames]
            z_p = (mean + eps * torch.exp(log_scale) * a.inference_noise_scale) * y_mask
            g_i = None if g is None else g[i : i + 1]
            z = vm.flow(z_p, y_mask, g=g_i)
            o = vm.waveform_decoder(z * y_mask, g=g_i, x_mask=y_mask)
            wavs.append(o[0, : frames * model.hop_length, 0].cpu().numpy())
    return wavs


def median_ms(fn, device, reps: int = 5) -> tuple:
    """``(median, min, max)`` milliseconds of ``reps`` synchronized calls."""
    runs = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        runs.append((time.perf_counter() - t0) * 1e3)
    runs.sort()
    return runs[reps // 2], runs[0], runs[-1]


def profile_call(fn, what: str, card: str) -> None:
    """Kernels launched and device busy share of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    log_profile(prof, what, wall_us, card, top=4)


def serve_mix(model_dir: str, max_batch: int, device, speakers=()) -> dict:
    """The serving mix as concurrent ``/api/tts`` requests to a server
    started from its command line with ``--max_batch``, the requests'
    ``speaker_id`` taken from ``speakers`` in turn: audio seconds, wall
    seconds, the batch sizes its worker formed (read by wrapping the
    batcher's ``_dispatch``) and the plans made."""
    import io

    import scipy.io.wavfile

    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP

    args = build_parser().parse_args(["--model_path", model_dir, "--port", "0", "--max_batch",
                                      str(max_batch), "--device", str(device)])
    srv = server_from_args(args)
    sizes = []
    if max_batch > 1:
        real = srv.batcher._dispatch

        def dispatch(batch):
            sizes.append(len(batch))
            real(batch)

        srv.batcher._dispatch = dispatch
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    urls = {f"{key}{n}": f"{base}/api/tts?text={urllib.parse.quote(VITS_SENTENCES[key])}"
            for key, count in VITS_MIX for n in range(count)}
    for i, key in enumerate(urls if speakers else ()):
        urls[key] += f"&speaker_id={speakers[i % len(speakers)]}"
    results: dict = {}
    try:
        with recorded_plans() as plans:
            t0 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(u, results, k))
                       for k, u in urls.items()]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            wall = time.perf_counter() - t0
    finally:
        close_server(srv)
        thread.join(timeout=60)
    if set(results) != set(urls):
        raise AssertionError(f"--max_batch {max_batch}: unanswered {sorted(set(urls) - set(results))}")
    audio_s = 0.0
    for key, res in results.items():
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(res["body"]))
        if res["status"] != 200 or sr != 22050 or len(pcm) <= SENTENCE_GAP \
                or pcm[:-SENTENCE_GAP].std() < 30:
            raise AssertionError(f"--max_batch {max_batch} {key!r}: HTTP {res['status']}, "
                                 f"{len(pcm)} samples")
        audio_s += len(pcm) / sr
    return {"audio_s": audio_s, "wall_s": wall, "sizes": sizes, "plans": list(plans)}


def time_row_billing(model, name: str, sentences, rows: int, card: str, device) -> dict:
    """The packed decode of ``sentences`` (``rows`` padded rows) under plans
    billed by eights and by ones: milliseconds (synchronized host clock,
    median of 5 each, in turns 8, 1, 1, 8, ...), rows, row length and
    utilization of each plan."""
    from tts_tpu_torch.utils.packing import plan_pack_layout
    from tts_tpu_torch.utils.synthesis import _frame_budget

    x, x_lengths = padded_ids(model, sentences, rows)
    budget = _frame_budget(max(len(model.tokenizer.text_to_ids(s)) for s in sentences))
    lens = model.infer_durations(x, x_lengths)[: len(sentences)].cpu().numpy()
    plans = {m: plan_pack_layout(lens, row_pad_multiple=m) for m in (8, 1)}

    def decode(plan):
        return model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                      noise_frames=budget, noise_layout="packed")

    for plan in plans.values():
        decode(plan)  # first call of each grid shape
    runs = {8: [], 1: []}
    for m in (8, 1, 1, 8, 8, 1, 1, 8, 8, 1):
        runs[m].append(median_ms(lambda: decode(plans[m]), device, reps=1)[0])
    out = {}
    for m, plan in plans.items():
        ms = sorted(runs[m])[2]
        out[m] = ms
        log(f"VITS row billing, {name} ({len(sentences)} sentences, {sum(lens)} frames): "
            f"row_pad_multiple {m}: {plan.n_rows} x {plan.row_len} grid, utilization "
            f"{plan.utilization:.3f}, packed decode {ms:.2f} ms (median of 5; "
            f"{min(runs[m]):.2f}-{max(runs[m]):.2f}) | {card}")
    return out


def save_model_dir(config, d: str) -> None:
    """Random fp32 weights from seed 0, drawn on the host, and the config
    into the model directory ``d``."""
    import torch

    from tts_tpu_torch.models.vits import Vits

    model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f)
    torch.save(model.module.state_dict(), os.path.join(d, "model_torch.pt"))


def card_against_cpu(synth, cpu_synth, text: str, **names) -> tuple:
    """One request through the card's and the CPU's ``Synthesizer`` on host
    noise: ``(samples, max abs diff, y_lengths, plans)``; raises unless the
    plans and ``y_lengths`` are equal and the waveforms within
    ``VITS_WAV_TOL``."""
    both = ("inference", "inference_packed")
    with host_noise(seed=0), recorded_plans() as plans, \
            recorded_y_lengths(synth.tts_model, both) as got_y, \
            recorded_y_lengths(cpu_synth.tts_model, both) as want_y:
        got = np.asarray(synth.tts(text, **names), np.float32)
        want = np.asarray(cpu_synth.tts(text, **names), np.float32)
    if plans:
        a, b = plans
        if (a.slices, a.n_rows, a.row_len) != (b.slices, b.n_rows, b.row_len) or not (
                np.array_equal(a.seg_sample, b.seg_sample) and np.array_equal(a.seg_pos, b.seg_pos)):
            raise AssertionError(f"{names}: pack plans differ, card {a.slices} CPU {b.slices}")
    if not got_y or got_y != want_y:
        raise AssertionError(f"{names}: y_lengths card {got_y} CPU {want_y}")
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    if not np.isfinite(got).all() or not err <= VITS_WAV_TOL:
        raise AssertionError(f"{names} card vs CPU: {got.shape} vs {want.shape}, "
                             f"max abs diff {err} (tol {VITS_WAV_TOL})")
    return got, err, got_y, plans


def phase_batched_vits(card: str, device="cuda", config=None) -> None:
    """Batched VITS serving at full width: card against CPU on one
    three-sentence request through the packed path, packed segments against
    their own masked decodes on the card, packed against serial wall time,
    the server's ``--max_batch 4`` against ``--max_batch 1`` on the serving
    mix, the row-billing timings and peak memory."""
    import torch

    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.utils.packing import ROW_PAD_MULTIPLE, plan_pack_layout
    from tts_tpu_torch.utils.synthesis import _frame_budget, synthesis
    from tts_tpu_torch.utils.synthesizer import Synthesizer, split_into_sentences

    cuda = torch.device(device).type == "cuda"
    config = config or vits_recipe_config()
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    request = vits_request()
    sens = split_into_sentences(request)
    with tempfile.TemporaryDirectory() as d:
        save_model_dir(config, d)
        synth = Synthesizer(model_dir=d, device=device)
        model = synth.tts_model
        cpu_synth = Synthesizer(model_dir=d, device="cpu")

        # card against CPU, one three-sentence request on host noise
        got, err, got_y, plans = card_against_cpu(synth, cpu_synth, request)
        del cpu_synth
        if len(sens) != 3 or len(plans) != 2 or len(got_y) != 1:
            raise AssertionError(f"packed request: {len(sens)} sentences, {len(plans)} plans, "
                                 f"y_lengths {got_y}")
        a = plans[0]
        tokens = [len(model.tokenizer.text_to_ids(sen)) for sen in sens]
        log(f"VITS packed request ({len(sens)} sentences of {tokens} tokens, one decode): "
            f"card vs CPU on host "
            f"noise: plans equal ({a.n_rows} x {a.row_len} grid, utilization "
            f"{a.utilization:.3f}, row_pad_multiple {ROW_PAD_MULTIPLE}), y_lengths {got_y[0]} "
            f"equal, waveform max abs diff {err:.3g} (tol {VITS_WAV_TOL}); "
            f"{len(got) / 22050:.2f} s of audio")

        # on the card: packed segments (batch noise layout) vs their own masked decodes
        x, x_lengths = padded_ids(model, sens, len(sens))
        budget = _frame_budget(x.shape[1])
        lens = model.infer_durations(x, x_lengths).cpu().numpy()
        plan = plan_pack_layout(lens)
        grid = model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                      noise_frames=budget, noise_layout="batch")["model_outputs"]
        hop = model.hop_length
        grid = grid[..., 0].cpu().numpy()
        worst = 0.0
        for (row, start, n), ref in zip(plan.slices, masked_decodes(model, x, x_lengths, budget)):
            seg = grid[row, start * hop : (start + n) * hop]
            if seg.shape != ref.shape:
                raise AssertionError(f"packed segment {seg.shape} vs masked decode {ref.shape}")
            worst = max(worst, float(np.abs(seg - ref).max()))
        if not worst <= VITS_MASKED_TOL:
            raise AssertionError(f"packed vs masked decodes: max abs diff {worst}")
        log(f"VITS packed (batch noise layout) vs each sentence's own masked decode, on the "
            f"card: lengths {lens.tolist()}, max abs diff {worst:.3g} (tol {VITS_MASKED_TOL})")

        # packed against the serial loop: the request's sentences to waveforms
        def packed():
            return synth._tts_sentences_packed(sens)

        def serial():
            return [synthesis(model, sen)["wav"] for sen in sens]

        audio_s = sum(len(w) for w in packed()) / 22050
        times = {"packed": [], "serial": []}
        for name in ("packed", "serial", "serial", "packed", "packed", "serial"):
            times[name].append(median_ms(packed if name == "packed" else serial, device)[0])
        for name, runs in times.items():
            log(f"VITS {name} three-sentence request: {audio_s:.2f} s of audio, {sorted(runs)[1]:.1f} "
                f"ms (median of 3 medians of 5; {min(runs):.1f}-{max(runs):.1f}) | {card}")
        if cuda:
            profile_call(packed, "VITS three-sentence request, packed (one decode)", card)
            profile_call(serial, "VITS three-sentence request, serial loop (three decodes)", card)

        # row billing: by eights (the JAX package's) against by ones
        short, medium = VITS_SENTENCES["short"], VITS_SENTENCES["medium"]
        long_a, long_b = split_into_sentences(VITS_SENTENCES["long"])
        mix = [short] * 2 + [medium] * 4 + [long_a, long_b] * 2
        billing = {"request": time_row_billing(model, "the three-sentence request", sens, 3,
                                               card, device),
                   "batch of 4": time_row_billing(model, "a batch of 4", [short, medium, long_a,
                                                                          long_b], 4, card, device),
                   "mix": time_row_billing(model, "the serving mix as one batch", mix, 16,
                                           card, device)}
        log("VITS row billing: faster by "
            + ", ".join(f"{k}: {'ones' if v[1] < v[8] else 'eights'} ({v[8]:.2f} vs {v[1]:.2f} ms)"
                        for k, v in billing.items())
            + f"; the port bills by {ROW_PAD_MULTIPLE} | {card}")

        # the server: --max_batch 1 and 4 on the serving mix, in turns 1, 4, 4, 1
        served = {1: [], 4: []}
        for max_batch in (1, 4, 4, 1):
            served[max_batch].append(serve_mix(d, max_batch, device))
        for max_batch, runs in served.items():
            rates = [r["audio_s"] / r["wall_s"] for r in runs]
            line = (f"VITS serving mix ({sum(c for _, c in VITS_MIX)} concurrent /api/tts: "
                    + ", ".join(f"{c} {k}" for k, c in VITS_MIX) + f"), --max_batch {max_batch}: "
                    + "; ".join(f"{r['audio_s']:.2f} s of audio in {r['wall_s']:.3f} s" for r in runs)
                    + f", {' and '.join(f'{v:.1f}' for v in rates)} audio s per wall s")
            if max_batch > 1:
                line += (f"; batch sizes formed {[r['sizes'] for r in runs]}; plan utilization "
                         + str([[round(p.utilization, 3) for p in r["plans"]] for r in runs]))
            log(line + f" | {card}")
        for r in served[4]:
            if sum(r["sizes"]) != sum(len(split_into_sentences(VITS_SENTENCES[k])) * c
                                      for k, c in VITS_MIX):
                raise AssertionError(f"--max_batch 4: batch sizes {r['sizes']}")
    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the batched VITS phase")
    log("VITS batched: no hand-written kernel on this path (decode_attention launches 0)")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        log(f"VITS batched peak device memory {peak / 1e9:.3f} GB allocated, "
            f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident before "
            f"the phase | {card}")


# ---------------------------------------------------------------------------
# VCTK's speakers as the recipe counts them: 109 names in VCTK's style (the
# corpus, and so its own list, is not in the repository)
VCTK_SPEAKERS = [f"p{n}" for n in range(225, 334)]
# the M-AILABS folders the multilingual recipe reads its languages from
# (``os.path.basename(path).split("_")[0]``); its speakers come from the
# data, which the repository lacks: ten stand-in names
MAILABS_FOLDERS = ("de_DE", "en_UK", "en_US", "es_ES", "fr_FR", "it_IT", "pl_PL", "ru_RU",
                   "uk_UK")
MAILABS_SPEAKERS = [f"speaker_{n}" for n in range(10)]
MULTI_SENTENCES = {
    "de": "Die Brücke über den Fluss wurde vor hundert Jahren gebaut.",
    "en": "The bridge over the river was built a hundred years ago.",
    "es": "El puente sobre el río fue construido hace cien años.",
    "fr": "Le pont sur la rivière a été construit il y a cent ans.",
    "it": "Il ponte sul fiume fu costruito cento anni fa.",
    "pl": "Most na rzece zbudowano sto lat temu.",
    "ru": "Мост через реку построили сто лет назад.",
    "uk": "Міст через річку збудували сто років тому.",
}
MIX_SPEAKERS = ("p225", "p243", "p270", "p301")  # the serving mix, in turn


def write_json(path: str, obj) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def vctk_recipe_config(speakers_file: str):
    """``recipes/vctk/vits/train_vits.py:23-37``'s inference fields at the
    ``VitsArgs`` defaults: ``english_cleaners``, phonemes for
    ``phoneme_language="en"`` (the rule G2P ``en_g2p``), blanks, 22.05 kHz;
    ``use_speaker_embedding`` set on ``model_args``, as the recipe sets it
    (ROADMAP.md F11), with 256 speaker channels and the duration predictor
    conditioned on the speaker (both defaults); the speakers from
    ``speakers_file``. ``num_chars`` is left to the tokenizer."""
    from tts_tpu_torch.models.vits import VitsConfig

    config = VitsConfig(text_cleaner="english_cleaners", use_phonemes=True, phoneme_language="en")
    a = config.model_args
    a.num_chars = None
    a.use_speaker_embedding = True
    a.speakers_file = speakers_file
    return config


def multilingual_recipe_config(d: str):
    """``recipes/multilingual/vits_tts/train_vits_tts_phonemes.py:30-54``:
    16 kHz, ``multilingual_cleaners``, the ``multi_phonemizer``, language
    embeddings of 4 channels, speaker embeddings, the deterministic duration
    predictor; the languages of its M-AILABS folders in a
    ``language_ids.json``, all of them in the embedding, and datasets (which
    pick the phonemizers) for the languages a phonemizer on this machine
    serves. Returns ``(config, served languages)``."""
    from tts_tpu_torch.config.shared import BaseDatasetConfig
    from tts_tpu_torch.models.vits import VitsConfig
    from tts_tpu_torch.text.phonemizers import DEF_LANG_TO_PHONEMIZER

    codes = sorted({folder.split("_")[0] for folder in MAILABS_FOLDERS})
    served = [c for c in codes if c in DEF_LANG_TO_PHONEMIZER]
    datasets = [BaseDatasetConfig(formatter="mailabs", dataset_name="mailabs",
                                  path=os.path.join(d, folder), language=folder.split("_")[0])
                for folder in MAILABS_FOLDERS if folder.split("_")[0] in served]
    config = VitsConfig(text_cleaner="multilingual_cleaners", use_phonemes=True,
                        phoneme_language=None, phonemizer="multi_phonemizer", datasets=datasets)
    config.audio.sample_rate = 16000
    a = config.model_args
    a.num_chars = None
    a.use_language_embedding = True
    a.embedded_language_dim = 4
    a.use_speaker_embedding = True
    a.use_sdp = False
    a.speakers_file = write_json(os.path.join(d, "speakers.json"),
                                 {n: i for i, n in enumerate(MAILABS_SPEAKERS)})
    a.language_ids_file = write_json(os.path.join(d, "language_ids.json"),
                                     {c: i for i, c in enumerate(codes)})
    return config, served


def batched_turn(synth, requests) -> list:
    """One ``DynamicBatcher`` dispatch of ``requests`` ``(text, speaker,
    language)``, each resolved and tokenized as the batcher's ``tts`` does:
    the items, with their waveforms."""
    from tts_tpu_torch.server.batching import DynamicBatcher, _Pending

    batcher = DynamicBatcher(synth, max_batch=len(requests))
    try:
        items = []
        for text, speaker, language in requests:
            speaker_id, _ = synth._resolve_speaker(speaker)
            language_id = synth._resolve_language(language)
            ids = synth.tts_model.tokenizer.text_to_ids(text, synth._language_name(language_id))
            items.append(_Pending(np.asarray(ids, np.int64), speaker_id, language_id))
        batcher._dispatch(items)
    finally:
        batcher.close()
    return items


def phase_multispeaker(card: str, single_ms: dict = None, device="cuda", cut=None) -> None:
    """Multi-speaker and multi-language VITS at the recipes' full widths on
    the card: VCTK (109 speakers) card against CPU for two speakers on one
    sentence and one packed request; a packed grid of four speakers against
    their own masked decodes; ``/api/tts`` with speakers, ``/details`` and
    the ``tts`` command line's speaker flags; the serving mix over four
    speakers, ``--max_batch 4`` against 1; the latency, busy share and peak
    memory of a medium sentence; then the multilingual recipe card against
    CPU for each language served, with one batched turn of mixed languages
    and speakers; and d-vectors, card against CPU. ``cut`` shrinks each
    config in place, for rehearsals on the CPU."""
    import io

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.managers import save_file
    from tts_tpu_torch.utils.packing import plan_pack_layout
    from tts_tpu_torch.utils.synthesis import _frame_budget, aux_input, synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer, split_into_sentences

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda config: config)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    medium = VITS_SENTENCES["medium"]
    request = vits_request()
    with tempfile.TemporaryDirectory() as d:
        speakers_file = write_json(os.path.join(d, "speakers.json"),
                                   {n: i for i, n in enumerate(VCTK_SPEAKERS)})
        save_model_dir(cut(vctk_recipe_config(speakers_file)), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        model = synth.tts_model
        a = model.args
        log(f"VITS VCTK recipe: {model.speaker_manager.num_speakers} speakers (speakers_file "
            f"on model_args), emb_g {tuple(model.module.emb_g.weight.shape)}, duration predictor "
            f"conditioned {a.condition_dp_on_speaker}; hidden {a.hidden_channels}, "
            f"{sum(p.numel() for p in model.module.parameters()) / 1e6:.2f} M parameters "
            f"(random, seed 0), phonemizer {model.tokenizer.phonemizer.name()}")

        # card against CPU: two speakers, one sentence and one packed request each
        worst, lines, wavs = 0.0, [], {}
        for speaker in ("p225", "p226"):
            for what, text in (("one sentence", medium), ("3-sentence request", request)):
                wav, err, y, plans = card_against_cpu(synth, cpu_synth, text, speaker_name=speaker)
                worst = max(worst, err)
                wavs[(speaker, what)] = wav
                lines.append(f"{speaker} {what}: y_lengths {y}"
                             + (f", plan {plans[0].n_rows} x {plans[0].row_len}" if plans else ""))
        del cpu_synth
        for what in ("one sentence", "3-sentence request"):
            x, y = wavs[("p225", what)], wavs[("p226", what)]
            n = min(len(x), len(y)) - SENTENCE_GAP
            if not np.abs(x[:n] - y[:n]).max() > 1e-3:
                raise AssertionError(f"speakers p225 and p226 speak the {what} alike")
        log(f"VITS VCTK card vs CPU on host noise, plans and y_lengths equal: " + "; ".join(lines)
            + f"; waveform max abs diff {worst:.3g} (tol {VITS_WAV_TOL}); p225 and p226 differ")

        # one packed grid, four sentences of four speakers, against their own decodes
        short, (long_a, long_b) = VITS_SENTENCES["short"], split_into_sentences(
            VITS_SENTENCES["long"])
        sens = [short, medium, long_a, long_b]
        x, x_lengths = padded_ids(model, sens, len(sens))
        ids = [model.speaker_manager.name_to_id[s] for s in MIX_SPEAKERS]
        aux = aux_input(model.device, len(sens), speaker_ids=ids)
        budget = _frame_budget(x.shape[1])
        lens = model.infer_durations(x, x_lengths, aux_input=aux).cpu().numpy()
        plan = plan_pack_layout(lens)
        grid = model.inference_packed(x, x_lengths, plan.seg_sample, plan.seg_pos,
                                      noise_frames=budget, noise_layout="batch",
                                      aux_input=aux)["model_outputs"][..., 0].cpu().numpy()
        hop, worst = model.hop_length, 0.0
        for (row, start, n), ref in zip(plan.slices, masked_decodes(model, x, x_lengths, budget,
                                                                    aux)):
            seg = grid[row, start * hop : (start + n) * hop]
            if seg.shape != ref.shape:
                raise AssertionError(f"packed segment {seg.shape} vs masked decode {ref.shape}")
            worst = max(worst, float(np.abs(seg - ref).max()))
        if not worst <= VITS_MASKED_TOL:
            raise AssertionError(f"mixed-speaker packed vs masked decodes: max abs diff {worst}")
        log(f"VITS packed grid of 4 speakers {list(MIX_SPEAKERS)} ({plan.n_rows} x "
            f"{plan.row_len}, lengths {lens.tolist()}) vs each one's own masked decode on the "
            f"card: max abs diff {worst:.3g} (tol {VITS_MASKED_TOL})")

        # HTTP: speakers through /api/tts, an unknown one refused, /details
        srv = server_from_args(build_parser().parse_args(
            ["--model_path", d, "--port", "0", "--device", str(device)]))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            spoken = _http(f"{base}/api/tts?text={urllib.parse.quote(medium)}&speaker_id=p226")
            unknown = _http(f"{base}/api/tts?text=hello&speaker_id=p999")
            details = json.loads(_http(f"{base}/details")[2])
        finally:
            close_server(srv)
            thread.join(timeout=60)
        if spoken[:2] != (200, "audio/wav") or unknown[0] != 400 or \
                b"not in the available speakers" not in unknown[2]:
            raise AssertionError(f"/api/tts with speakers: HTTP {spoken[0]}, unknown speaker "
                                 f"HTTP {unknown[0]} {unknown[2][:80]!r}")
        if details["speakers"] != VCTK_SPEAKERS:
            raise AssertionError(f"/details: {len(details['speakers'])} speakers")
        pcm = scipy.io.wavfile.read(io.BytesIO(spoken[2]))[1]
        log(f"VITS VCTK server: /api/tts?speaker_id=p226 {len(pcm)} samples; unknown speaker "
            f"HTTP 400; /details lists {len(details['speakers'])} speakers")

        # the tts command line: --list_speaker_idxs, then a file per --speaker_idx
        listed = io.StringIO()
        with contextlib.redirect_stdout(listed):
            synthesize_cli(["--model_path", d, "--list_speaker_idxs", "--device", str(device)])
        if str(VCTK_SPEAKERS) not in listed.getvalue():
            raise AssertionError("tts --list_speaker_idxs does not list the 109 speakers")
        cli_path, api_path = os.path.join(d, "cli.wav"), os.path.join(d, "api.wav")
        synthesize_cli(["--text", medium, "--model_path", d, "--speaker_idx", "p226",
                        "--out_path", cli_path, "--device", str(device)])
        TTS(model_path=d, device=device).tts_to_file(medium, speaker="p226", file_path=api_path)
        (sr, cli_pcm), (_, api_pcm) = (scipy.io.wavfile.read(p) for p in (cli_path, api_path))
        step = (np.abs(cli_pcm.astype(np.int32) - api_pcm.astype(np.int32)).max()
                if cli_pcm.shape == api_pcm.shape else None)
        if step is None or step > 1:
            raise AssertionError(f"tts --speaker_idx {cli_pcm.shape} vs TTS.tts_to_file "
                                 f"{api_pcm.shape}: {step} int16 steps")
        log(f"VITS VCTK tts command line: --list_speaker_idxs lists 109; --speaker_idx p226 "
            f"{len(cli_pcm)} samples at {sr} Hz, at most {step} int16 step from "
            f"TTS.tts_to_file's")

        # the serving mix over four speakers: --max_batch 1 and 4, in turns 1, 4, 4, 1
        served = {1: [], 4: []}
        for max_batch in (1, 4, 4, 1):
            served[max_batch].append(serve_mix(d, max_batch, device, MIX_SPEAKERS))
        for max_batch, runs in served.items():
            rates = [r["audio_s"] / r["wall_s"] for r in runs]
            line = (f"VITS VCTK serving mix over speakers {list(MIX_SPEAKERS)}, --max_batch "
                    f"{max_batch}: " + "; ".join(f"{r['audio_s']:.2f} s of audio in "
                                                 f"{r['wall_s']:.3f} s" for r in runs)
                    + f", {' and '.join(f'{v:.1f}' for v in rates)} audio s per wall s")
            if max_batch > 1:
                line += f"; batch sizes formed {[r['sizes'] for r in runs]}"
            log(line + f" | {card}")
        n_sentences = sum(len(split_into_sentences(VITS_SENTENCES[k])) * c for k, c in VITS_MIX)
        for r in served[4]:
            if sum(r["sizes"]) != n_sentences or max(r["sizes"]) < 2:
                raise AssertionError(f"--max_batch 4 with speakers: batch sizes {r['sizes']}")

        # the medium sentence of one speaker: latency, busy share
        synthesis(model, medium, speaker_id=1)
        ms, lo, hi = median_ms(lambda: synthesis(model, medium, speaker_id=1), device)
        single = f"; phase 6's single-speaker medium sentence {single_ms['medium']:.1f} ms" \
            if single_ms else ""
        log(f"VITS VCTK medium sentence, speaker p226: {ms:.1f} ms (median of 5; "
            f"{lo:.1f}-{hi:.1f}){single} | {card}")
        if cuda:
            profile_call(lambda: synthesis(model, medium, speaker_id=1),
                         "VITS VCTK, one medium sentence of one speaker", card)
        del synth, model

    with tempfile.TemporaryDirectory() as d:
        config, served_languages = multilingual_recipe_config(d)
        save_model_dir(cut(config), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        model = synth.tts_model
        log(f"VITS multilingual recipe: languages {model.language_manager.language_names} "
            f"(emb_l {tuple(model.module.emb_l.weight.shape)}), served by this machine's "
            f"phonemizers {served_languages}; {model.speaker_manager.num_speakers} speakers; "
            f"{model.config.audio.sample_rate} Hz, duration predictor "
            f"{type(model.module.duration_predictor).__name__}")
        worst, lengths = 0.0, {}
        for n, language in enumerate(served_languages):
            speaker = MAILABS_SPEAKERS[n % len(MAILABS_SPEAKERS)]
            _, err, y, _ = card_against_cpu(synth, cpu_synth, MULTI_SENTENCES[language],
                                            speaker_name=speaker, language_name=language)
            worst = max(worst, err)
            lengths[language] = y[0]
        requests = [(MULTI_SENTENCES[lang], MAILABS_SPEAKERS[n], lang)
                    for n, lang in enumerate(served_languages)]
        with host_noise(seed=0):
            got, want = batched_turn(synth, requests), batched_turn(cpu_synth, requests)
        turn = max(float(np.abs(g.wav - w.wav).max()) if g.wav.shape == w.wav.shape
                   else float("inf") for g, w in zip(got, want))
        if not turn <= VITS_WAV_TOL or any(g.wav.std() == 0 for g in got):
            raise AssertionError(f"multilingual batched turn card vs CPU: max abs diff {turn}")
        del cpu_synth, synth, model
        log(f"VITS multilingual card vs CPU on host noise, one sentence per language "
            f"{served_languages}: waveform max abs diff {worst:.3g}; one batched turn of "
            f"{len(requests)} sentences in {len(requests)} languages and speakers: max abs diff "
            f"{turn:.3g} (tol {VITS_WAV_TOL})")

    with tempfile.TemporaryDirectory() as d:
        rs = np.random.RandomState(0)
        clips = {f"{s}_{n}.wav": {"name": s, "embedding": rs.randn(512).tolist()}
                 for s in VCTK_SPEAKERS[:8] for n in range(2)}
        save_file(clips, os.path.join(d, "d_vectors.npz"))
        config = vctk_recipe_config(None)
        a = config.model_args
        a.use_speaker_embedding, a.use_d_vector_file, a.d_vector_dim = False, True, 512
        a.d_vector_file = os.path.join(d, "d_vectors.npz")
        save_model_dir(cut(config), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        worst = 0.0
        for text in (medium, request):
            worst = max(worst, card_against_cpu(synth, cpu_synth, text, speaker_name="p226")[1])
        log(f"VITS d-vectors (512 wide, 8 speakers of 2 clips, VCTK widths) card vs CPU on host "
            f"noise, one sentence and one packed request: max abs diff {worst:.3g} "
            f"(tol {VITS_WAV_TOL})")
        del cpu_synth, synth

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the multi-speaker phase")
    log(f"VITS multi-speaker: no hand-written kernel on this path (decode_attention launches "
        f"0); phase 8 took {time.time() - t_phase:.1f} s")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        log(f"VITS multi-speaker peak device memory {peak / 1e9:.3f} GB allocated, "
            f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident "
            f"before the phase | {card}")


# ---------------------------------------------------------------------------
ZOO_VCTK = "tts_models/en/vctk/vits"
GROUP_FIT_ROWS = (2, 4, 8)
GROUP_FIT_FRAMES = (512, 1024, 2048)


def mb_istft_config():
    """Phase 6's LJSpeech recipe with the MB-iSTFT-VITS decoder as published
    (arXiv:2210.15975, its ``ljs_mb_istft_vits`` config): a HiFiGAN trunk of
    [4, 4] with kernels [16, 16] from 512 channels, then a 16-point iSTFT at
    hop 4 in each of 4 PQMF bands: 4 x 4 x 4 x 4 = the hop of 256."""
    config = vits_recipe_config()
    a = config.model_args
    a.decoder_type = "istft"
    a.upsample_rates_decoder = [4, 4]
    a.upsample_kernel_sizes_decoder = [16, 16]
    a.istft_n_fft_decoder, a.istft_hop_decoder, a.istft_subbands_decoder = 16, 4, 4
    return config


def encoder_rate_config():
    """Phase 6's LJSpeech recipe at a 44.1 kHz output, its text encoder,
    durations, posterior encoder and flow at 22.05 kHz (the reference's
    ``VitsArgs.encoder_sample_rate``), the latent upsampled twice
    (``interpolate_z``) into the default HiFiGAN (hop 256). No published
    checkpoint fixes the pair: the factor of 2 is the JAX package's own
    test's (``tests/test_vits_upsampling.py``), here at full width."""
    config = vits_recipe_config()
    config.audio.sample_rate = 44100
    config.model_args.encoder_sample_rate = 22050
    config.model_args.interpolate_z = True
    return config


@contextlib.contextmanager
def offline_zoo(home: str):
    """``TTS_HOME`` at ``home`` and ``TTS_TPU_MODELS_FILE`` at a copy of the
    port's catalog there; any fetch raises."""
    import shutil
    import urllib.request as request

    from tts_tpu_torch.utils import manage

    models_file = os.path.join(home, "models.json")
    shutil.copy(manage._DEFAULT_MODELS_FILE, models_file)
    saved = {k: os.environ.get(k) for k in ("TTS_HOME", "TTS_TPU_MODELS_FILE")}
    real = request.urlretrieve

    def no_fetch(url, *args, **kwargs):
        raise AssertionError(f"the zoo phase tried to fetch {url}")

    os.environ.update(TTS_HOME=home, TTS_TPU_MODELS_FILE=models_file)
    request.urlretrieve = no_fetch
    try:
        yield
    finally:
        request.urlretrieve = real
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


@contextlib.contextmanager
def recorded_groups(plans=None):
    """Every group plan the batcher's grouped dispatch makes inside: the
    sizes and buckets of each (and, into ``plans``, the predicted lengths
    and the plan)."""
    from tts_tpu_torch.server import batching

    groups = []
    real = batching.plan_decode_groups

    def recording(y_preds, *args, **kwargs):
        plan = real(y_preds, *args, **kwargs)
        groups.append([(len(idx), frames) for idx, frames in plan])
        if plans is not None:
            plans.append((list(y_preds), plan))
        return plan

    batching.plan_decode_groups = recording
    try:
        yield groups
    finally:
        batching.plan_decode_groups = real


def planned_against_decoded(plan_record, decoded) -> str:
    """The lengths the grouped dispatch planned against those its groups'
    decodes gave, which must be equal since each group decodes on its
    plan's durations (ROADMAP.md F16), and the number of groups."""
    y_preds, plan = plan_record
    planned = [min(int(y_preds[i]), frames) for idx, frames in plan for i in idx]
    lengths = [int(n) for (idx, _), ys in zip(plan, decoded) for n in ys[: len(idx)]]
    if planned != lengths:
        raise AssertionError(f"grouped dispatch: planned lengths {planned}, decoded {lengths}")
    return (f"{len(plan)} group(s); planned lengths {planned}, decoded {lengths}: equal "
            f"(F16 settled)")


def fit_group_overhead(model, device) -> dict:
    """``plan_decode_groups``' ``overhead``, in frame·row units: one decode
    dispatch's fixed floor (``inference`` of one row at 32 frames, median of
    5) over its marginal cost per latent frame of one row (the least-squares
    slope of ``inference`` timed at ``GROUP_FIT_ROWS`` x ``GROUP_FIT_FRAMES``,
    median of 3 each, sizes at which the device's work outlasts the host's
    dispatch). Each row holds the medium sentence."""
    rows_max = max(GROUP_FIT_ROWS)
    x, x_lengths = padded_ids(model, [VITS_SENTENCES["medium"]] * rows_max, rows_max)

    def timed(rows, frames, reps):
        def call():
            model.inference(x[:rows], x_lengths[:rows], max_frames=frames)
        call()
        return median_ms(call, device, reps=reps)[0]

    floor = timed(1, 32, 5)
    points = [(rows * frames, timed(rows, frames, 3))
              for rows in GROUP_FIT_ROWS for frames in GROUP_FIT_FRAMES]
    units = np.array([u for u, _ in points], np.float64)
    ms = np.array([t for _, t in points], np.float64)
    (intercept, slope), *_ = np.linalg.lstsq(np.stack([np.ones_like(units), units], 1), ms,
                                             rcond=None)
    resid = ms - (intercept + slope * units)
    return {"floor_ms": floor, "slope_ms": float(slope), "intercept_ms": float(intercept),
            "overhead": float(floor / slope), "points": points,
            "max_resid_ms": float(np.abs(resid).max())}


def phase_zoo_and_variants(card: str, device="cuda", cut=None) -> None:
    """The zoo, voice conversion and the iSTFT and encoder-rate variants at
    full width: (a) the VCTK recipe (phase 8) saved as a zoo directory in
    the reference layout under a temporary ``TTS_HOME``, loaded by name
    through ``TTS`` and ``tts --model_name`` against the same files loaded
    by path; (b) a wav the port speaks as p225 converted to p226, card
    against CPU on host noise; (c) the MB-iSTFT-VITS decoder and an
    encoder-rate model, card against CPU on three sentences, the medium
    sentence's latency and RTF, and the grouped dispatch's overhead fitted
    on the iSTFT model; (d) the iSTFT model behind the batcher: one grouped
    turn card against CPU, and the serving mix with ``--max_batch 1`` and 4
    with the groups formed. ``cut`` shrinks each config in place, for
    rehearsals on the CPU."""
    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.audio.numpy_transforms import load_wav
    from tts_tpu_torch.audio.torch_transforms import wav_to_spec
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server import batching
    from tts_tpu_torch.utils.convert import reference_vits_state
    from tts_tpu_torch.utils.synthesis import DECODE_GROUP_OVERHEAD, synthesis
    from tts_tpu_torch.utils.synthesizer import Synthesizer, split_into_sentences

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda config: config)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    medium = VITS_SENTENCES["medium"]

    # (a) the zoo: the VCTK recipe as a zoo directory, by name against by path
    with tempfile.TemporaryDirectory() as home, offline_zoo(home):
        d = os.path.join(home, "tts_tpu", ZOO_VCTK.replace("/", "--"))
        os.makedirs(d)
        torch.save({n: i for i, n in enumerate(VCTK_SPEAKERS)}, os.path.join(d, "speakers.pth"))
        model = Vits.init_from_config(cut(vctk_recipe_config(os.path.join(d, "speakers.pth")))
                                      ).init_params(seed=0, device="cpu")
        saved = model.config.to_dict()
        saved["model_args"]["speakers_file"] = "/published/vctk/speakers.pth"
        write_json(os.path.join(d, "config.json"), saved)
        weights = os.path.join(d, "model_file.pth")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              reference_vits_state(model.module.state_dict()).items()}}, weights)
        del model
        t0 = time.time()
        by_name = TTS(model_name=ZOO_VCTK, device=device)
        load_s = time.time() - t0
        config_path = os.path.join(d, "config.json")
        by_path = TTS(model_path=weights, config_path=config_path, device=device)
        if by_name.speakers != VCTK_SPEAKERS:
            raise AssertionError(f"zoo load: {len(by_name.speakers)} speakers")
        a = np.asarray(by_name.tts(medium, speaker="p226"), np.float32)
        b = np.asarray(by_path.tts(medium, speaker="p226"), np.float32)
        err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
        if not err <= VITS_WAV_TOL or a.std() == 0:
            raise AssertionError(f"TTS(model_name) vs path load: {a.shape} vs {b.shape}, {err}")
        del by_name
        cli_path, api_path = os.path.join(home, "cli.wav"), os.path.join(home, "api.wav")
        synthesize_cli(["--text", medium, "--model_name", ZOO_VCTK, "--speaker_idx", "p226",
                        "--out_path", cli_path, "--device", str(device)])
        by_path.tts_to_file(medium, speaker="p226", file_path=api_path)
        (sr, cli_pcm), (_, api_pcm) = (scipy.io.wavfile.read(p) for p in (cli_path, api_path))
        step = (np.abs(cli_pcm.astype(np.int32) - api_pcm.astype(np.int32)).max()
                if cli_pcm.shape == api_pcm.shape else None)
        if step is None or step > 1:
            raise AssertionError(f"tts --model_name {cli_pcm.shape} vs path load "
                                 f"{api_pcm.shape}: {step} int16 steps")
        log(f"zoo: {ZOO_VCTK} from a TTS_HOME holding model_file.pth (reference layout), "
            f"config.json (speakers path rewritten) and speakers.pth ({len(VCTK_SPEAKERS)} "
            f"speakers), nothing fetched; TTS(model_name) loaded in {load_s:.1f} s and speaks "
            f"the path-loaded model's medium sentence (p226) within {err:.3g}; tts --model_name "
            f"{len(cli_pcm)} samples at {sr} Hz, at most {step} int16 step from the path load")

        # (b) voice conversion: the port's own p225 recording into p226's voice
        ref_wav = os.path.join(home, "p225.wav")
        by_path.tts_to_file(medium, speaker="p225", file_path=ref_wav)
        synth = by_path.synthesizer
        cpu_synth = Synthesizer(tts_checkpoint=weights, tts_config_path=config_path,
                                device="cpu")

        def convert(s):
            return np.asarray(s.tts(reference_wav=ref_wav, speaker_name="p226",
                                    reference_speaker_name="p225"), np.float32)

        with host_noise(seed=0):
            got, want = convert(synth), convert(cpu_synth)
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        if not err <= VITS_WAV_TOL or not np.isfinite(got).all() or got.std() == 0:
            raise AssertionError(f"voice conversion card vs CPU: {got.shape} vs {want.shape}, "
                                 f"max abs diff {err}")
        ms, lo, hi = median_ms(lambda: convert(synth), device)
        seconds = len(got) / 22050
        # the sizes the posterior meets: the spectrogram, its log-scale, its sample
        audio = synth.tts_config.audio
        wav = torch.from_numpy(load_wav(filename=ref_wav, sample_rate=22050)[None]).to(device)
        spec = wav_to_spec(wav, audio.fft_size, audio.hop_length, audio.win_length)
        with host_noise(seed=0):
            z, _, logs, _ = synth.tts_model.module.posterior_encoder(
                spec.transpose(1, 2), torch.tensor([spec.shape[2]], device=device),
                torch.Generator(device=device), g=synth.tts_model.module.emb_g(
                    torch.tensor([0], device=device)))
        sizes = (f"max |spectrogram| {float(spec.abs().max()):.1f}, max log-scale "
                 f"{float(logs.max()):.2f}, max |z| {float(z.abs().max()):.1f}")
        log(f"voice conversion p225 -> p226 of the port's own {seconds:.2f} s recording, card "
            f"vs CPU on host noise: {len(got)} samples each, max abs diff {err:.3g} (tol "
            f"{VITS_WAV_TOL}); {ms:.1f} ms on {device} (median of 5; {lo:.1f}-{hi:.1f}), RTF "
            f"{seconds / ms * 1e3:.1f}; posterior of random weights: {sizes} | {card}")
        del cpu_synth, synth, by_path

    # (c) the variants, card against CPU, latency, and the grouped dispatch's overhead
    fit = None
    for name, config in (("MB-iSTFT", mb_istft_config()), ("encoder rate", encoder_rate_config())):
        config = cut(config)
        model = Vits.init_from_config(config).init_params(seed=0, device=device)
        cpu_model = Vits.init_from_config(config).init_params(seed=0, device="cpu")
        a, sr = model.args, model.config.audio.sample_rate
        worst, lengths = 0.0, []
        with host_noise(seed=0):
            for text in VITS_SENTENCES.values():
                g, w = synthesis(model, text), synthesis(cpu_model, text)
                g_len, w_len = g["outputs"]["y_lengths"].cpu(), w["outputs"]["y_lengths"]
                if not torch.equal(g_len, w_len) or g["wav"].shape != w["wav"].shape:
                    raise AssertionError(f"{name}: y_lengths card {g_len.tolist()} CPU "
                                         f"{w_len.tolist()}")
                err = float(np.abs(g["wav"] - w["wav"]).max())
                if not err <= VITS_WAV_TOL or not np.isfinite(g["wav"]).all():
                    raise AssertionError(f"{name} card vs CPU: max abs diff {err}")
                worst, lengths = max(worst, err), lengths + [int(g_len[0])]
        del cpu_model
        synthesis(model, medium)
        ms, lo, hi = median_ms(lambda: synthesis(model, medium), device)
        seconds = len(synthesis(model, medium)["wav"]) / sr
        log(f"VITS {name} ({a.decoder_type} decoder, upsampling {a.upsample_rates_decoder}"
            + (f", iSTFT n_fft {a.istft_n_fft_decoder} hop {a.istft_hop_decoder} x "
               f"{a.istft_subbands_decoder} bands" if a.decoder_type == "istft" else "")
            + f"; {sr} Hz out, encoder rate {a.encoder_sample_rate}, {model.hop_length} samples "
            f"per latent frame; {sum(p.numel() for p in model.module.parameters()) / 1e6:.2f} M "
            f"parameters, seed 0): card vs CPU on host noise, y_lengths {lengths} equal, "
            f"waveform max abs diff {worst:.3g} (tol {VITS_WAV_TOL}); medium sentence "
            f"{seconds:.2f} s of audio in {ms:.1f} ms (median of 5; {lo:.1f}-{hi:.1f}), RTF "
            f"{seconds / ms * 1e3:.1f} | {card}")
        if cuda:
            profile_call(lambda: synthesis(model, medium), f"VITS {name}, one medium sentence",
                         card)
        if a.decoder_type == "istft":
            fit = fit_group_overhead(model, device)
            log(f"grouped-dispatch overhead fit on the {name} VITS (inference of the medium "
                f"sentence): floor {fit['floor_ms']:.2f} ms per dispatch (1 row x 32 frames, "
                f"median of 5); slope {fit['slope_ms'] * 1e3:.3f} us per frame-row "
                f"(least squares over rows {list(GROUP_FIT_ROWS)} x frames "
                f"{list(GROUP_FIT_FRAMES)}, median of 3 each; intercept "
                f"{fit['intercept_ms']:.2f} ms, largest residual {fit['max_resid_ms']:.2f} ms); "
                f"overhead = floor / slope = {fit['overhead']:.0f} frame-rows "
                f"(DECODE_GROUP_OVERHEAD in the port: {DECODE_GROUP_OVERHEAD}); points "
                f"(frame-rows, ms) " + ", ".join(f"({u}, {t:.2f})" for u, t in fit["points"])
                + f" | {card}")
        del model

    # (d) the iSTFT model behind the batcher: the grouped dispatch
    with tempfile.TemporaryDirectory() as d:
        save_model_dir(cut(mb_istft_config()), d)
        synth = Synthesizer(model_dir=d, device=device)
        cpu_synth = Synthesizer(model_dir=d, device="cpu")
        long_a, long_b = split_into_sentences(VITS_SENTENCES["long"])
        requests = [(t, None, None) for t in (VITS_SENTENCES["short"], medium, long_a, long_b)]
        plans = []
        with host_noise(seed=0), recorded_groups(plans) as groups, \
                recorded_y_lengths(synth.tts_model, ("inference",)) as decoded:
            got, want = batched_turn(synth, requests), batched_turn(cpu_synth, requests)
        turn = max(float(np.abs(g.wav - w.wav).max()) if g.wav.shape == w.wav.shape
                   else float("inf") for g, w in zip(got, want))
        if not turn <= VITS_WAV_TOL or groups[0] != groups[1] or any(
                g.wav.std() == 0 for g in got):
            raise AssertionError(f"grouped turn card vs CPU: max abs diff {turn}, groups {groups}")
        log(f"VITS MB-iSTFT grouped dispatch of 4 sentences, card vs CPU on host noise: groups "
            f"(size, bucket) {groups[0]} on both, max abs diff {turn:.3g} (tol {VITS_WAV_TOL}); "
            + planned_against_decoded(plans[0], decoded))
        # two groups (a dispatch priced at 0): each group decodes on its plan's durations
        # (ROADMAP.md F16)
        plans, real = [], batching.plan_decode_groups
        batching.plan_decode_groups = functools.partial(real, overhead=0)
        try:
            with recorded_groups(plans), \
                    recorded_y_lengths(synth.tts_model, ("inference",)) as decoded:
                batched_turn(synth, requests)
        finally:
            batching.plan_decode_groups = real
        log(f"VITS MB-iSTFT grouped dispatch priced at overhead 0, on the card: groups "
            f"{[(len(idx), frames) for idx, frames in plans[0][1]]}; "
            + planned_against_decoded(plans[0], decoded))
        del cpu_synth, synth
        served = {1: [], 4: []}
        for max_batch in (1, 4, 4, 1):
            with recorded_groups() as groups:
                run = serve_mix(d, max_batch, device)
            run["groups"] = list(groups)
            served[max_batch].append(run)
        n_sentences = sum(len(split_into_sentences(VITS_SENTENCES[k])) * c for k, c in VITS_MIX)
        for max_batch, runs in served.items():
            rates = [r["audio_s"] / r["wall_s"] for r in runs]
            line = (f"VITS MB-iSTFT serving mix, --max_batch {max_batch}: "
                    + "; ".join(f"{r['audio_s']:.2f} s of audio in {r['wall_s']:.3f} s"
                                for r in runs)
                    + f", {' and '.join(f'{v:.1f}' for v in rates)} audio s per wall s")
            if max_batch > 1:
                line += (f"; batch sizes {[r['sizes'] for r in runs]}, groups (size, bucket) "
                         f"{[r['groups'] for r in runs]}")
                for r in runs:
                    if sum(r["sizes"]) != n_sentences or not r["groups"]:
                        raise AssertionError(f"--max_batch 4 on the iSTFT model: batch sizes "
                                             f"{r['sizes']}, groups {r['groups']}")
            log(line + f" | {card}")

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the zoo and variants phase")
    log(f"zoo, voice conversion and VITS variants: no hand-written kernel on this path "
        f"(decode_attention launches 0); phase 9 took {time.time() - t_phase:.1f} s")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        log(f"phase 9 peak device memory {peak / 1e9:.3f} GB allocated, "
            f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident "
            f"before the phase | {card}")


# ---------------------------------------------------------------------------
ZOO_GLOW = "tts_models/en/ljspeech/glow-tts"
ZOO_MBMELGAN = "vocoder_models/en/ljspeech/multiband-melgan"
FOREIGN_STATS = "/published/ljspeech/multiband-melgan/scale_stats.npy"
GLOW_MEL_TOL = 1e-4  # card vs CPU, the GlowTTS mel, fp32 with TF32 off
GL_REL_TOL = 1e-2  # card vs CPU, Griffin-Lim's waveform, as a share of its peak
FIDELITY_RMSE, FIDELITY_LSD_DB = 5e-3, 0.5  # tests/test_fidelity_corpus.py's thresholds


def glow_recipe_config():
    """``recipes/ljspeech/glow_tts/train_glowtts.py:21-33`` as published:
    ``phoneme_cleaners``, ``en-us`` phonemes (from the rule G2P where
    ``espeak`` is absent) and the ``GlowTTSConfig`` defaults, the embedding
    sized by the phoneme set."""
    from tts_tpu_torch.models.glow_tts import GlowTTSConfig

    return GlowTTSConfig(text_cleaner="phoneme_cleaners", use_phonemes=True,
                         phoneme_language="en-us")


def mb_melgan_recipe_config():
    """``recipes/ljspeech/multiband_melgan/train_multiband_melgan.py:15-25``:
    the ``MultibandMelganConfig`` defaults (384 base channels, upsampling
    [8, 4, 2], 4 residual blocks a stage, 4 PQMF bands; 22.05 kHz, hop 256,
    80 mels)."""
    from tts_tpu_torch.vocoder.configs import MultibandMelganConfig

    return MultibandMelganConfig()


def random_vocoder(config, seed: int = 0):
    """The generator ``config`` names, on the CPU, with fp32 weights drawn
    from ``seed``: N(0, 1/fan_in) (a transposed conv's fan-in is its input
    channels times its taps per output, kernel / stride), biases 0; the
    shared smoothing taps (``up_<i>``) and WaveRNN's folded norms keep their
    initial values."""
    import torch

    from tts_tpu_torch.vocoder.utils import make_generator_from_config

    gen = make_generator_from_config(config)
    draw = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("up_") or leaf.endswith(("_scale", "_shift")):
                continue  # smoothing taps at 1 / k, folded norms the identity, as initialised
            owner = gen.get_submodule(name.rsplit(".", 1)[0]) if "." in name else gen
            if "bias" in leaf:
                p.zero_()
                continue
            if isinstance(owner, torch.nn.ConvTranspose1d):
                fan_in = p.shape[0] * p.shape[2] // owner.stride[0]
            else:
                fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=draw) / fan_in**0.5)
    return gen.eval().requires_grad_(False)


def melgan_gflop(gen, frames: int, padded: bool = True) -> float:
    """Operations (2 per multiply-add) of a MelGAN generator's ``inference``
    on ``frames`` mel frames (with its edge padding unless ``padded`` is
    false): ``conv_pre``, each transposed
    conv (every input frame meets its ``2u`` taps), each residual block's
    dilated conv, 1x1 conv and 1x1 shortcut at the upsampled rate,
    ``conv_post``, and the PQMF synthesis filter of a multi-band one."""
    n = frames + (2 * gen.inference_padding if padded else 0)
    flops = 2 * gen.conv_pre.in_channels * gen.conv_pre.out_channels * gen.proj_kernel * n
    for i, up in enumerate(gen.ups):
        flops += 2 * up.in_channels * up.out_channels * up.kernel_size[0] * n
        n *= up.stride[0]
        stack = getattr(gen, f"res_{i}")
        c = up.out_channels
        flops += stack.num_res_blocks * 2 * c * c * (stack.kernel_size + 2) * n
    flops += 2 * gen.conv_post.in_channels * gen.conv_post.out_channels * gen.proj_kernel * n
    if hasattr(gen, "pqmf"):
        flops += 2 * gen.pqmf.N * (gen.pqmf.taps + 1) * n * gen.pqmf.N
    return flops / 1e9


def write_scale_stats(path: str, audio: dict, seed: int = 0) -> None:
    """A ``scale_stats.npy`` as the reference's statistics script writes it
    (mel and linear means and deviations in decibels, and the audio config
    they were computed with), drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    n, lin = audio["num_mels"], audio["fft_size"] // 2 + 1
    np.save(path, {"mel_mean": rs.randn(n) * 5 - 40, "mel_std": rs.rand(n) * 5 + 10,
                   "linear_mean": rs.randn(lin) * 5 - 40, "linear_std": rs.rand(lin) * 5 + 10,
                   "audio_config": dict(audio)}, allow_pickle=True)


def _lsd_db(ref: np.ndarray, ours: np.ndarray) -> float:
    """``tests/test_fidelity_corpus.py``'s log-mel distance in dB (a 64-point
    STFT, 20 mels at 1.6 kHz: the fixtures' waveforms are a few hundred
    samples), through the port's numpy transforms."""
    from tts_tpu_torch.audio.numpy_transforms import build_mel_basis, stft

    def log_mel(wav):
        spec = np.abs(stft(y=wav.astype(np.float32), fft_size=64, hop_length=16, win_length=64,
                           pad_mode="reflect"))
        basis = build_mel_basis(sample_rate=1600, fft_size=64, num_mels=20)
        return 20.0 * np.log10(np.maximum(basis @ spec, 1e-5))

    a, b = log_mel(ref), log_mel(ours)
    return float(np.mean(np.sqrt(np.mean((a - b) ** 2, axis=0))))


def fidelity_replays(device) -> str:
    """``glow_tts.npz`` and ``multiband_melgan.npz`` (reference-layout state
    dicts with the reference code's outputs) through the port's converters
    on ``device``, at ``test_fidelity_corpus``'s thresholds."""
    import torch

    from tts_tpu_torch.models.glow_tts import GlowTTS, GlowTTSConfig
    from tts_tpu_torch.utils.convert import load_reference_glow_tts, load_reference_vocoder
    from tts_tpu_torch.vocoder.configs import MultibandMelganConfig
    from tts_tpu_torch.vocoder.utils import make_generator_from_config

    def fixture(name):
        npz = np.load(os.path.join(REPO, "tests", "fixtures", "fidelity", f"{name}.npz"))
        meta = json.loads(bytes(npz["meta"]).decode())
        part = {p: {k[len(p) + 1:]: npz[k] for k in npz.files if k.startswith(p + "/")}
                for p in ("sd", "in", "out")}
        return part["sd"], part["in"], part["out"], meta

    state, ins, outs, meta = fixture("glow_tts")
    config = GlowTTSConfig()
    for k, v in meta["config"].items():
        setattr(config, k, v)
    glow = GlowTTS(config)
    glow.load_state_dict({k: v.to(device) for k, v in load_reference_glow_tts(state,
                                                                               config).items()})
    ref_lens = outs["y_lengths"]
    with torch.no_grad():
        out = glow.inference(torch.from_numpy(ins["text"]).to(device),
                             torch.from_numpy(ins["text_lengths"]).to(device),
                             max_frames=int(((ref_lens.max() + 31) // 32) * 32))
    lens = out["y_lengths"].cpu().numpy()
    mel = out["model_outputs"].float().cpu().numpy()
    ours = np.concatenate([mel[b, :n] for b, n in enumerate(ref_lens)])
    ref = np.concatenate([outs["mel"][b, :n] for b, n in enumerate(ref_lens)])
    rmse = float(np.sqrt(np.mean((ours - ref) ** 2))) if ours.shape == ref.shape else np.inf
    if not np.array_equal(lens, ref_lens) or not rmse < FIDELITY_RMSE:
        raise AssertionError(f"glow_tts.npz on {device}: y_lengths {lens} vs {ref_lens}, "
                             f"mel RMSE {rmse}")

    state, ins, outs, meta = fixture("multiband_melgan")
    vconfig = MultibandMelganConfig()
    vconfig.audio.num_mels = ins["mel"].shape[1]
    vconfig.generator_model_params = {"upsample_factors": [2, 2], "base_channels": 32,
                                      "num_res_blocks": meta["num_res_blocks"]}
    gen = make_generator_from_config(vconfig)
    gen.load_state_dict(load_reference_vocoder(state, vconfig))
    gen = gen.to(device).eval()
    with torch.no_grad():
        wav = gen.inference(torch.from_numpy(ins["mel"].transpose(0, 2, 1)).to(device))
    wav = wav.float().cpu().numpy()[0, :, 0]
    lsd = _lsd_db(outs["wav"][0, 0], wav) if len(wav) == outs["wav"].shape[-1] else np.inf
    if not lsd < FIDELITY_LSD_DB:
        raise AssertionError(f"multiband_melgan.npz on {device}: {len(wav)} samples, LSD {lsd}")
    return (f"glow_tts.npz y_lengths {lens.tolist()} equal, mel RMSE {rmse:.3g} (< "
            f"{FIDELITY_RMSE}); multiband_melgan.npz LSD {lsd:.3g} dB (< {FIDELITY_LSD_DB}), max "
            f"abs diff {float(np.abs(outs['wav'][0, 0] - wav).max()):.3g}")


def glow_stage_ms(synth, text: str, device, reps: int = 5) -> dict:
    """One sentence's stages on the card, medians of ``reps``: the encoder
    with the duration predictor, the path expansion (durations, monotonic
    path, prior), the flow decoder in reverse and MB-MelGAN by CUDA events;
    the host bridge (mel to the host, denormalise, renormalise, back to the
    card) by the host clock."""
    import torch

    from tts_tpu_torch.utils.synthesis import _frame_budget

    model = synth.tts_model
    gm = model.module
    ids = model.tokenizer.text_to_ids(text)
    T = ((len(ids) + 15) // 16) * 16
    x = torch.zeros(1, T, dtype=torch.long, device=device)
    x[0, : len(ids)] = torch.tensor(ids, device=device)
    xl = torch.tensor([len(ids)], device=device)
    budget = _frame_budget(len(ids))
    runs: dict = {}
    with torch.no_grad():
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            o_mean, o_log_scale, o_dur_log, x_mask = gm.enc(x, xl)
            ev[1].record()
            e = gm.encode(x, xl, max_frames=budget)  # the path expansion, after the encoder
            ev[2].record()
            y, _, _ = gm.dec(e["y_mean"] * e["y_mask"], e["y_mask"], reverse=True)
            ev[3].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = int(e["y_lengths"][0])
            mel = y[0, :frames].float().cpu().numpy()
            voc_in = synth.vocoder_ap.normalize(synth.ap.denormalize(mel.T))
            c = torch.from_numpy(np.ascontiguousarray(voc_in.T[None], np.float32)).to(device)
            torch.cuda.synchronize()
            bridge = (time.perf_counter() - t0) * 1e3
            v0, v1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            v0.record()
            synth.vocoder_model.inference(c)
            v1.record()
            torch.cuda.synchronize()
            encode_ms = ev[0].elapsed_time(ev[1])
            times = {"encoder + durations": encode_ms,
                     "path expansion": ev[1].elapsed_time(ev[2]) - encode_ms,
                     "flow decoder": ev[2].elapsed_time(ev[3]), "host bridge": bridge,
                     "MB-MelGAN": v0.elapsed_time(v1)}
            for k, v in times.items():
                runs.setdefault(k, []).append(v)
    return {"times": {k: sorted(v)[reps // 2] for k, v in runs.items()}, "frames": frames,
            "budget": budget, "tokens": len(ids)}


def phase_glow_tts(card: str, device="cuda", cut=None) -> None:
    """GlowTTS with Multiband-MelGAN at the LJSpeech recipes' widths (the
    ``tts`` command line's default pairing): the two fidelity fixtures
    replayed on the card; the three phase 6 sentences card against CPU
    (``y_lengths`` and mel, then the waveform through the vocoder bridge);
    latency and RTF at B=1 with a stage split, MB-MelGAN's TFLOP/s, busy
    share, kernels and peak memory; Griffin-Lim without a vocoder, card
    against CPU under one ``np.random.seed``; the pair by zoo name from
    reference-layout directories (nothing fetched; the vocoder's
    ``stats_path`` names its trainer's file, F17) against the path load;
    the ``tts`` command line's vocoder flags; and the server with
    ``--vocoder_path`` and ``--max_batch 4``, which serves serially.
    ``decode_attention`` must not launch. ``cut`` shrinks both configs in
    place, for rehearsals on the CPU."""
    import io
    import shutil

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.convert import reference_glow_tts_state, reference_melgan_state
    from tts_tpu_torch.utils.synthesis import synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda glow_config, voc_config: None)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    medium = VITS_SENTENCES["medium"]

    def silent(fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` without the Synthesizer's per-call lines."""
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    log(f"fidelity replays on {device}: " + fidelity_replays(device) + f" | {card}")

    glow_config, voc_config = glow_recipe_config(), mb_melgan_recipe_config()
    cut(glow_config, voc_config)
    with tempfile.TemporaryDirectory() as d:
        glow_dir, voc_dir = os.path.join(d, "glow"), os.path.join(d, "voc")
        os.makedirs(glow_dir)
        os.makedirs(voc_dir)
        glow = GlowTTS.init_from_config(glow_config).init_params(seed=0, device="cpu")
        write_json(os.path.join(glow_dir, "config.json"), glow.config.to_dict())
        torch.save(glow.module.state_dict(), os.path.join(glow_dir, "model_torch.pt"))
        gen = random_vocoder(voc_config, seed=0)
        write_json(os.path.join(voc_dir, "config.json"), voc_config.to_dict())
        torch.save(gen.state_dict(), os.path.join(voc_dir, "model_torch.pt"))
        c = glow.config
        n_glow = sum(p.numel() for p in glow.module.parameters())
        n_voc = sum(p.numel() for p in gen.parameters())
        per_s = (melgan_gflop(gen, 1, padded=False) * voc_config.audio.sample_rate
                 / voc_config.audio.hop_length)
        gp = voc_config.generator_model_params
        log(f"GlowTTS (LJSpeech recipe, phonemes from {glow.tokenizer.phonemizer.name()}, "
            f"{c.text_cleaner}, num_chars {c.num_chars}): encoder {c.hidden_channels_enc} ch, "
            f"{c.encoder_params['num_layers']} relative-attention layers, "
            f"{c.encoder_params['num_heads']} heads, FFN {c.encoder_params['hidden_channels_ffn']}"
            f", prenet, duration predictor {c.hidden_channels_dp}; decoder "
            f"{c.num_flow_blocks_dec} flow blocks of {c.num_block_layers} WN layers at "
            f"{c.hidden_channels_dec} ch, kernel {c.kernel_size_dec}, {c.num_splits} splits, "
            f"squeeze {c.num_squeeze}; {n_glow / 1e6:.2f} M parameters (seed 0; zero-init leaves "
            f"drawn at a tenth scale, duration bias for ~6 frames a token). MB-MelGAN: "
            f"{gen.conv_pre.out_channels} base channels, upsampling {gp['upsample_factors']}, "
            f"{gp['num_res_blocks']} residual blocks a stage, {gen.pqmf.N} PQMF bands, "
            f"{voc_config.audio.sample_rate} Hz, hop {voc_config.audio.hop_length}; "
            f"{n_voc / 1e6:.2f} M parameters (seed 0); {per_s:.2f} GFLOP per second of audio")
        del glow, gen
        glow_args = ["--model_path", os.path.join(glow_dir, "model_torch.pt"), "--config_path",
                     os.path.join(glow_dir, "config.json")]
        voc_args = ["--vocoder_path", os.path.join(voc_dir, "model_torch.pt"),
                    "--vocoder_config_path", os.path.join(voc_dir, "config.json")]

        def load(dev, vocoder=True):
            kw = dict(vocoder_checkpoint=voc_args[1], vocoder_config=voc_args[3]) \
                if vocoder else {}
            return Synthesizer(tts_checkpoint=glow_args[1], tts_config_path=glow_args[3],
                               device=dev, **kw)

        # card against CPU: the mel, then the waveform through the bridge
        synth, cpu_synth = load(device), load("cpu")
        worst_mel = worst_wav = 0.0
        lengths, budgets, audio_s = [], [], []
        with torch.no_grad():
            for text in VITS_SENTENCES.values():
                g, w = synthesis(synth.tts_model, text), synthesis(cpu_synth.tts_model, text)
                g_len, w_len = g["outputs"]["y_lengths"].cpu(), w["outputs"]["y_lengths"]
                if not torch.equal(g_len, w_len) or g["model_outputs"].shape != \
                        w["model_outputs"].shape:
                    raise AssertionError(f"GlowTTS y_lengths card {g_len.tolist()} != CPU "
                                         f"{w_len.tolist()} for {text!r}")
                err = float(np.abs(g["model_outputs"] - w["model_outputs"]).max())
                if not err <= GLOW_MEL_TOL or not np.isfinite(g["model_outputs"]).all():
                    raise AssertionError(f"GlowTTS mel card vs CPU: max abs diff {err}")
                gw, ww = synth._vocode(g["model_outputs"]), cpu_synth._vocode(w["model_outputs"])
                werr = float(np.abs(gw - ww).max()) if gw.shape == ww.shape else np.inf
                if not werr <= VITS_WAV_TOL or not np.isfinite(gw).all() or gw.std() == 0:
                    raise AssertionError(f"GlowTTS + MB-MelGAN card vs CPU: {gw.shape} vs "
                                         f"{ww.shape}, max abs diff {werr}")
                worst_mel, worst_wav = max(worst_mel, err), max(worst_wav, werr)
                lengths.append(int(g_len[0]))
                budgets.append(int(g["outputs"]["model_outputs"].shape[1]))
                audio_s.append(len(gw) / synth.output_sample_rate)
        cut_note = ", ".join(f"{n}/{b}" for n, b in zip(lengths, budgets))
        log(f"GlowTTS + MB-MelGAN card vs CPU, the three phase 6 sentences: y_lengths {lengths} "
            f"equal, mel max abs diff {worst_mel:.3g} (tol {GLOW_MEL_TOL}), waveform through "
            f"the vocoder bridge {worst_wav:.3g} (tol {VITS_WAV_TOL}); frames/budget {cut_note}"
            f" ({'none' if all(n < b for n, b in zip(lengths, budgets)) else 'some'} cut at "
            f"the frame budget)")

        # speed at B=1: Synthesizer.tts per sentence (trim included), median of 5
        silent(synth.tts, medium)
        for key, text in VITS_SENTENCES.items():
            ms, lo, hi = median_ms(lambda: silent(synth.tts, text), device)
            seconds = (len(silent(synth.tts, text)) - SENTENCE_GAP) / synth.output_sample_rate
            log(f"GlowTTS + MB-MelGAN {key}: {seconds:.2f} s of audio (after the trim) in "
                f"{ms:.1f} ms (median of 5; {lo:.1f}-{hi:.1f}), RTF {seconds / ms * 1e3:.1f} "
                f"| {card}")
        if cuda:
            st = glow_stage_ms(synth, medium, device)
            mb = st["times"]["MB-MelGAN"]
            gflop = melgan_gflop(synth.vocoder_model, st["frames"])
            log(f"GlowTTS stages, medium sentence ({st['tokens']} tokens, {st['frames']} frames, "
                f"budget {st['budget']}), ms (median of 5; CUDA events, the bridge by the host "
                f"clock): " + ", ".join(f"{k} {v:.2f}" for k, v in st["times"].items())
                + f"; MB-MelGAN {gflop:.2f} GFLOP, {gflop / mb:.1f} TFLOP/s, "
                f"{100 * gflop / mb * 1e12 / FP32_FLOPS_PER_S:.1f} % of the fp32 peak | {card}")
            profile_call(lambda: silent(synth.tts, medium),
                         "GlowTTS + MB-MelGAN, one medium sentence through Synthesizer.tts", card)

        # Griffin-Lim: no vocoder, the same first phases on card and CPU
        gl, cpu_gl = load(device, vocoder=False), load("cpu", vocoder=False)
        np.random.seed(0)
        a = np.asarray(silent(gl.tts, medium), np.float32)
        np.random.seed(0)
        b = np.asarray(silent(cpu_gl.tts, medium), np.float32)
        peak = float(np.abs(b).max())
        err = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
        if not err <= GL_REL_TOL * peak or not np.isfinite(a).all() or peak == 0:
            raise AssertionError(f"Griffin-Lim card vs CPU: {a.shape} vs {b.shape}, max abs diff "
                                 f"{err} of peak {peak}")
        mel = synthesis(gl.tts_model, medium)["model_outputs"]
        np.random.seed(0)
        t0 = time.perf_counter()
        gl.ap.inv_melspectrogram(mel.T)
        gl_ms = (time.perf_counter() - t0) * 1e3
        log(f"Griffin-Lim ({gl.ap.griffin_lim_iters} iterations, no vocoder), medium sentence: "
            f"card vs CPU after np.random.seed(0), {len(a)} samples each, max abs diff "
            f"{err:.3g} of peak {peak:.3g} (tol {GL_REL_TOL} of the peak); Griffin-Lim alone "
            f"{gl_ms:.0f} ms on the host")
        del gl, cpu_gl, cpu_synth

        # the zoo by name: reference-layout directories, nothing fetched
        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            zg = os.path.join(home, "tts_tpu", ZOO_GLOW.replace("/", "--"))
            zv = os.path.join(home, "tts_tpu", ZOO_MBMELGAN.replace("/", "--"))
            os.makedirs(zg)
            os.makedirs(zv)
            glow_state = torch.load(glow_args[1], weights_only=True)
            torch.save({"model": {k: torch.from_numpy(v) for k, v in
                                  reference_glow_tts_state(glow_state).items()}},
                       os.path.join(zg, "model_file.pth"))
            shutil.copy(glow_args[3], os.path.join(zg, "config.json"))
            torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_melgan_state(
                torch.load(voc_args[1], weights_only=True)).items()}},
                os.path.join(zv, "model_file.pth"))
            vsaved = voc_config.to_dict()
            vsaved["audio"]["stats_path"] = FOREIGN_STATS
            write_json(os.path.join(zv, "config.json"), vsaved)
            write_scale_stats(os.path.join(zv, "scale_stats.npy"), vsaved["audio"], seed=0)
            t0 = time.time()
            by_name = TTS(model_name=ZOO_GLOW, device=device)
            load_s = time.time() - t0
            with open(os.path.join(zv, "config.json")) as f:
                stats_path = json.load(f)["audio"]["stats_path"]
            if stats_path != os.path.join(zv, "scale_stats.npy") or not hasattr(
                    by_name.synthesizer.vocoder_ap, "mel_scaler"):
                raise AssertionError(f"zoo vocoder stats_path {stats_path!r} (F17)")
            by_path = TTS(model_path=os.path.join(zg, "model_file.pth"),
                          config_path=os.path.join(zg, "config.json"),
                          vocoder_path=os.path.join(zv, "model_file.pth"),
                          vocoder_config_path=os.path.join(zv, "config.json"), device=device)
            a = np.asarray(silent(by_name.tts, medium), np.float32)
            b = np.asarray(silent(by_path.tts, medium), np.float32)
            zerr = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
            if zerr != 0 or a.std() == 0:
                raise AssertionError(f"TTS(model_name={ZOO_GLOW}) vs path load: {a.shape} vs "
                                     f"{b.shape}, max abs diff {zerr}")
            log(f"zoo: {ZOO_GLOW} with its default vocoder {ZOO_MBMELGAN} from reference-layout "
                f"directories (model_file.pth, config.json; the vocoder's scale_stats.npy, its "
                f"stats_path rewritten from the trainer's, F17), nothing fetched; loaded in "
                f"{load_s:.1f} s; the medium sentence differs from the path load by {zerr}")
            del by_name, by_path

        # the command line with the vocoder flags against the API
        api = TTS(model_path=glow_args[1], config_path=glow_args[3], vocoder_path=voc_args[1],
                  vocoder_config_path=voc_args[3], device=device)
        api_path, cli_path = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
        silent(api.tts_to_file, medium, file_path=api_path)
        silent(synthesize_cli, ["--text", medium, "--out_path", cli_path, "--device",
                                str(device)] + glow_args + voc_args)
        (sr, api_pcm), (cli_sr, cli_pcm) = (scipy.io.wavfile.read(p) for p in (api_path,
                                                                              cli_path))
        step = (np.abs(cli_pcm.astype(np.int32) - api_pcm.astype(np.int32)).max()
                if cli_pcm.shape == api_pcm.shape else None)
        if step is None or step > 1 or cli_sr != sr or sr != voc_config.audio.sample_rate:
            raise AssertionError(f"tts --vocoder_path {cli_pcm.shape} at {cli_sr} Hz vs the API "
                                 f"{api_pcm.shape} at {sr} Hz: {step} int16 steps")
        log(f"tts --model_path --config_path --vocoder_path --vocoder_config_path: "
            f"{len(cli_pcm)} samples at {cli_sr} Hz, at most {step} int16 step from "
            f"TTS.tts_to_file")
        del api

        # the server with the vocoder flags and --max_batch 4: served serially
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            srv = server_from_args(build_parser().parse_args(
                glow_args + voc_args + ["--max_batch", "4", "--port", "0",
                                        "--device", str(device)]))
        if "serving serially" not in said.getvalue() or srv.batcher is not None:
            raise AssertionError(f"server with a vocoder and --max_batch 4: {said.getvalue()!r}")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        results: dict = {}
        try:
            t1 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(
                f"{base}/api/tts?text={urllib.parse.quote(t)}", results, k))
                for k, t in VITS_SENTENCES.items()]
            with contextlib.redirect_stdout(io.StringIO()):
                for cl in clients:
                    cl.start()
                for cl in clients:
                    cl.join(timeout=600)
            served_s = time.perf_counter() - t1
        finally:
            close_server(srv)
            thread.join(timeout=60)
        served_audio = 0.0
        for key in VITS_SENTENCES:
            res = results.get(key) or {}
            if res.get("status") != 200:
                raise AssertionError(f"GlowTTS /api/tts {key!r}: {res.get('status')}")
            rate, pcm = scipy.io.wavfile.read(io.BytesIO(res["body"]))
            if rate != sr or len(pcm) <= SENTENCE_GAP or pcm[:-SENTENCE_GAP].std() < 30:
                raise AssertionError(f"GlowTTS /api/tts {key!r}: {rate} Hz, {len(pcm)} samples")
            served_audio += len(pcm) / rate
        line = [ln for ln in said.getvalue().splitlines() if "serially" in ln][0].strip()
        log(f"GlowTTS server (--vocoder_path, --max_batch 4): said {line!r}; 3 concurrent "
            f"/api/tts requests, {served_audio:.2f} s of audio in {served_s:.2f} s | {card}")
        del synth

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the GlowTTS phase")
    line = "GlowTTS + MB-MelGAN: no hand-written kernel on this path (decode_attention launches 0)"
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 10 took {time.time() - t_phase:.1f} s | {card}")


ZOO_T2 = "tts_models/en/ljspeech/tacotron2-DDC"
ZOO_HIFIGAN_V2 = "vocoder_models/en/ljspeech/hifigan_v2"
T2_TOL = 1e-4  # card vs CPU, the Tacotron2 mel and waveform, fp32 with TF32 off
T2_DECODE_R = 2  # the recipe's last gradual-training step: r 2 of the projection's 6 (F20)
T2_B4_STEPS = 400  # decode steps of the B=4 check and its B=1 decodes


def tacotron2_recipe_config():
    """``recipes/ljspeech/tacotron2_ddc/train_tacotron_ddc.py:24-36`` as
    published: ``r=6`` with the gradual-training schedule down to 2, DDC
    (``ddc_r`` 6), ``phoneme_cleaners``, ``en-us`` phonemes and the
    ``Tacotron2Config`` defaults (512-wide encoder, 1024-wide attention and
    decoder LSTMs, prenet 256, attention 128, location-sensitive attention
    with sigmoid normalisation); ``norm_type="folded"``, as a converted
    checkpoint runs."""
    from tts_tpu_torch.models.tacotron2 import Tacotron2Config

    return Tacotron2Config(
        r=6, gradual_training=[[0, 6, 64], [10000, 4, 32], [50000, 3, 32], [100000, 2, 32]],
        double_decoder_consistency=True, ddc_r=6, text_cleaner="phoneme_cleaners",
        use_phonemes=True, phoneme_language="en-us", norm_type="folded")


def tacotron2_dca_recipe_config():
    """``recipes/ljspeech/tacotron2_dca/train_tacotron_dca.py:22-52``: its
    audio (22.05 kHz, no signal normalisation, mels 0-8000 Hz, natural log,
    ``ref_level_db`` 20, no preemphasis), ``r=2``, dynamic convolution
    attention, ``phoneme_cleaners`` with ``en-us`` phonemes; folded norms."""
    from tts_tpu_torch.config.shared import BaseAudioConfig
    from tts_tpu_torch.models.tacotron2 import Tacotron2Config

    audio = BaseAudioConfig(sample_rate=22050, do_trim_silence=True, trim_db=60.0,
                            signal_norm=False, mel_fmin=0.0, mel_fmax=8000, spec_gain=1.0,
                            log_func="np.log", ref_level_db=20, preemphasis=0.0)
    return Tacotron2Config(audio=audio, r=2, attention_type="dynamic_convolution",
                           double_decoder_consistency=False, text_cleaner="phoneme_cleaners",
                           use_phonemes=True, phoneme_language="en-us", norm_type="folded")


def hifigan_recipe_config():
    """``recipes/ljspeech/hifigan/train_hifigan.py:12-22``: the
    ``HifiganConfig`` defaults (upsampling [8, 8, 2, 2] from 512 channels,
    resblocks of kernels 3, 7, 11; 22.05 kHz, hop 256, 80 mels)."""
    from tts_tpu_torch.vocoder.configs import HifiganConfig

    return HifiganConfig()


def random_tacotron2(config, seed: int = 0, stop_bias: float = -10.0):
    """``Tacotron2.init_from_config(config)`` with fp32 weights from
    ``seed`` on the CPU, the stopnet's weight zero and its bias
    ``stop_bias``: at -10 random weights run every decode to its budget, the
    worst case the budget exists for, and card and CPU cannot disagree on a
    stop near 0.5."""
    import torch

    from tts_tpu_torch.models.tacotron2 import Tacotron2

    model = Tacotron2.init_from_config(config).init_params(seed=seed, device="cpu")
    stopnet = model.module.decoder_cell.stopnet
    with torch.no_grad():
        stopnet.weight.zero_()
        stopnet.bias.fill_(stop_bias)
    return model


def tacotron2_fidelity(device) -> str:
    """``tacotron2.npz`` (a reference-layout state at full width, rebuilt
    from its manifest as ``tests/helpers.py`` rebuilds it; teacher-forced at
    r = 2 by the reference code) through ``load_reference_tacotron2`` on
    ``device``, at ``test_fidelity_corpus``'s mel RMSE bound."""
    import torch

    from tts_tpu_torch.models.tacotron2 import Tacotron2, Tacotron2Config
    from tts_tpu_torch.utils.convert import load_reference_tacotron2

    npz = np.load(os.path.join(REPO, "tests", "fixtures", "fidelity", "tacotron2.npz"))
    meta = json.loads(bytes(npz["meta"]).decode())
    rs = np.random.RandomState(meta["state_seed"])
    state = {}
    for name, (shape, dtype) in meta["state_manifest"].items():
        if name.endswith("num_batches_tracked"):
            state[name] = np.zeros(shape, np.int64)
        elif name.endswith("running_var"):
            state[name] = (0.5 + np.abs(rs.randn(*shape))).astype(np.float32)
        elif name.endswith("running_mean"):
            state[name] = (0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            state[name] = (0.1 * rs.randn(*shape)).astype(dtype)
    config = Tacotron2Config(num_chars=meta["num_chars"], r=meta["r"], attention_norm="softmax")
    model = Tacotron2(config)
    model.load_state_dict({k: v.to(device) for k, v in load_reference_tacotron2(state,
                                                                                config).items()})
    text, mel = npz["in/text"], npz["in/mel"]
    with torch.no_grad():
        out = model.module(torch.from_numpy(text).to(device),
                           torch.full((text.shape[0],), text.shape[1], device=device),
                           torch.from_numpy(mel).to(device))
    ours = out["model_outputs"].float().cpu().numpy()
    rmse = float(np.sqrt(np.mean((ours - npz["out/mel"]) ** 2)))
    if not rmse < FIDELITY_RMSE:
        raise AssertionError(f"tacotron2.npz on {device}: mel RMSE {rmse}")
    return f"tacotron2.npz teacher-forced at r 2, mel RMSE {rmse:.3g} (< {FIDELITY_RMSE})"


def drift_per_steps(a: np.ndarray, b: np.ndarray, r: int, steps: int = 100) -> list:
    """Largest ``|a - b|`` over each run of ``steps`` decode steps (``r``
    frames a step) of two mels ``[T, C]``."""
    d = np.abs(a - b).max(axis=1)
    return [float(d[i: i + steps * r].max()) for i in range(0, len(d), steps * r)]


def t2_ids(model, texts, device):
    """Token ids of ``texts`` padded to the widest, in multiples of 16 as
    ``synthesis`` pads them, with their lengths."""
    import torch

    rows = [model.tokenizer.text_to_ids(t) for t in texts]
    width = ((max(len(r) for r in rows) + 15) // 16) * 16
    x = torch.zeros(len(rows), width, dtype=torch.long)
    for i, r in enumerate(rows):
        x[i, : len(r)] = torch.tensor(r)
    return x.to(device), torch.tensor([len(r) for r in rows], device=device)


def step_ms(decode, device, lo: int, hi: int) -> float:
    """Milliseconds per step of ``decode(n)``, a decode of ``n`` steps that
    never stops sooner: the slope of its wall time (synchronized, median
    of 3) between ``lo`` and ``hi`` steps."""
    import torch

    times = {}
    with torch.no_grad():
        decode(lo)
        for n in (lo, hi):
            times[n] = median_ms(lambda: decode(n), device, reps=3)[0]
    return (times[hi] - times[lo]) / (hi - lo)


def kernels_per_step(decode, what: str, card: str, lo: int, hi: int):
    """Kernels and device milliseconds a step of ``decode(n)`` takes (the
    differences between two profiled decodes of ``lo`` and ``hi`` steps,
    over ``hi - lo``), with the busy share of the longer."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts, busy = {}, {}
    for n in (lo, hi):
        with torch.no_grad():
            decode(n)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                decode(n)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t1) * 1e6
        rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
                and e.self_device_time_total > 0]
        counts[n] = sum(e.count for e in rows)
        busy[n] = sum(e.self_device_time_total for e in rows) / 1e3
    log_profile(prof, what.format(hi), wall_us, card, top=4)
    return (counts[hi] - counts[lo]) / (hi - lo), (busy[hi] - busy[lo]) / (hi - lo)


def t2_step_ms(model, texts, device, lo: int = 100, hi: int = 300) -> float:
    """Milliseconds per Tacotron2 decode step at the batch of ``texts``
    (:func:`step_ms` between ``lo`` and ``hi`` steps)."""
    x, xl = t2_ids(model, texts, device)
    return step_ms(lambda n: model.inference(x, xl, max_steps=n), device, lo, hi)


def t2_kernels_per_step(model, texts, device, card: str, lo: int = 50, hi: int = 150):
    """Kernels and device milliseconds a Tacotron2 decode step takes at the
    batch of ``texts`` (:func:`kernels_per_step`)."""
    x, xl = t2_ids(model, texts, device)
    return kernels_per_step(lambda n: model.inference(x, xl, max_steps=n),
                            f"Tacotron2 B={len(texts)} decode of {{}} steps (never stopping)",
                            card, lo, hi)


def t2_stage_ms(synth, text: str, steps: int, device, reps: int = 5) -> dict:
    """One sentence at ``steps`` decode steps, by stage, medians of
    ``reps``: the encoder (with the attention's input projection) and the
    whole ``inference`` by the host clock (synchronized), the postnet and
    HiFiGAN by CUDA events, the mel to the host with the bridge by the host
    clock; the decode loop is ``inference`` less its encoder and postnet."""
    import torch

    model, m = synth.tts_model, synth.tts_model.module
    x, xl = t2_ids(model, [text], device)
    runs: dict = {}
    with torch.no_grad():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m._attention_inputs(m._encode(x, xl))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            o = model.inference(x, xl, max_steps=steps)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            m.postnet(o["decoder_outputs"])
            ev[1].record()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            mel = o["model_outputs"][0, : int(o["mel_lengths"][0])].float().cpu().numpy()
            voc_in = synth.vocoder_ap.normalize(synth.ap.denormalize(mel.T))
            c = torch.from_numpy(np.ascontiguousarray(voc_in.T[None], np.float32)).to(device)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            ev[2].record()
            synth.vocoder_model.inference(c)
            ev[3].record()
            torch.cuda.synchronize()
            encoder, postnet = (t1 - t0) * 1e3, ev[0].elapsed_time(ev[1])
            times = {"encoder": encoder, "decode loop": (t2 - t1) * 1e3 - encoder - postnet,
                     "postnet": postnet, "host bridge": (t4 - t3) * 1e3,
                     "HiFiGAN": ev[2].elapsed_time(ev[3])}
            for k, v in times.items():
                runs.setdefault(k, []).append(v)
    return {k: sorted(v)[reps // 2] for k, v in runs.items()}


def phase_tacotron2(card: str, device="cuda", cut=None) -> None:
    """Tacotron2-DDC with HiFiGAN at the LJSpeech recipes' widths: the
    recipe's model (r_init 6) decoded at r = 2 from a reference-layout
    checkpoint that says so (F20); ``tacotron2.npz`` on the card; the short
    and medium phase 6 sentences card against CPU at their whole budgets (mel and
    waveform, the drift per 100 decode steps); the DCA recipe card against
    CPU; B = 4 rows against their own B = 1 decodes; the stopnet firing at
    step 1 (the early exit); ms per decode step at B = 1 and 4, kernels per
    step, busy share, latency and RTF at natural length and at the whole
    budget, HiFiGAN's share, peak memory; the pair by zoo name; ``tts
    --vocoder_path``; the server, serial. ``decode_attention`` must not
    launch. ``cut`` shrinks the three configs in place, for rehearsals on
    the CPU."""
    import io
    import shutil

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.tacotron2 import model as t2_model
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args
    from tts_tpu_torch.utils.convert import reference_tacotron2_state
    from tts_tpu_torch.utils.synthesis import _frame_budget, synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer, split_into_sentences

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda t2_config, dca_config, voc_config: None)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    short, medium = VITS_SENTENCES["short"], VITS_SENTENCES["medium"]

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    log(f"Tacotron2 fidelity replay on {device}: " + tacotron2_fidelity(device) + f" | {card}")

    t2_config, dca_config, voc_config = (tacotron2_recipe_config(), tacotron2_dca_recipe_config(),
                                         hifigan_recipe_config())
    cut(t2_config, dca_config, voc_config)
    with tempfile.TemporaryDirectory() as d:
        t2_dir, voc_dir = os.path.join(d, "t2"), os.path.join(d, "voc")
        os.makedirs(t2_dir)
        os.makedirs(voc_dir)
        t2 = random_tacotron2(t2_config, seed=0)
        n_t2 = sum(p.numel() for p in t2.module.parameters())
        torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_tacotron2_state(
            t2.module.state_dict()).items()}, "r": T2_DECODE_R},
            os.path.join(t2_dir, "model_file.pth"))
        write_json(os.path.join(t2_dir, "config.json"), t2.config.to_dict())
        gen = random_vocoder(voc_config, seed=0)
        n_voc = sum(p.numel() for p in gen.parameters())
        torch.save({"model": {"model_g." + k: v for k, v in gen.state_dict().items()}},
                   os.path.join(voc_dir, "model_file.pth"))
        write_json(os.path.join(voc_dir, "config.json"), voc_config.to_dict())
        c = t2.config
        del t2, gen
        t2_args = ["--model_path", os.path.join(t2_dir, "model_file.pth"), "--config_path",
                   os.path.join(t2_dir, "config.json")]
        voc_args = ["--vocoder_path", os.path.join(voc_dir, "model_file.pth"),
                    "--vocoder_config_path", os.path.join(voc_dir, "config.json")]

        def load(dev):
            return Synthesizer(tts_checkpoint=t2_args[1], tts_config_path=t2_args[3],
                               vocoder_checkpoint=voc_args[1], vocoder_config=voc_args[3],
                               device=dev)

        synth, cpu_synth = load(device), load("cpu")
        model = synth.tts_model
        if (model.r_init, model.r) != (6, T2_DECODE_R):
            raise AssertionError(f"F20: r_init {model.r_init}, r {model.r} from a 480-wide "
                                 f"projection and r {T2_DECODE_R} in the checkpoint")
        gp = voc_config.generator_model_params
        log(f"Tacotron2-DDC (LJSpeech recipe, phonemes from {model.tokenizer.phonemizer.name()}, "
            f"{c.text_cleaner}, num_chars {c.num_chars}): embedding {c.embedding_dim}, encoder "
            f"{c.encoder_in_features} (3 convs, biLSTM), attention LSTM {c.query_dim}, decoder "
            f"LSTM {c.decoder_rnn_dim}, prenet {c.prenet_dim}, {c.attention_type} attention "
            f"({c.attention_norm}, location {c.location_attn}) {c.attn_dim}, postnet 5 x 512; "
            f"{n_t2 / 1e6:.2f} M parameters (seed 0, the DDC coarse decoder not built), loaded "
            f"from the reference layout: r_init {model.r_init} from the projection, r "
            f"{model.r} from the checkpoint (F20); stopnet weight 0, bias -10 (never stops). "
            f"HiFiGAN: {gp['upsample_initial_channel']} channels, upsampling "
            f"{gp['upsample_factors']}, {voc_config.audio.sample_rate} Hz, hop "
            f"{voc_config.audio.hop_length}; {n_voc / 1e6:.2f} M parameters (seed 0)")

        # card against CPU at the short and medium sentences' whole budgets: mel,
        # then the waveform (the long one's 4096 frames on the CPU were cut for
        # the script's time limit)
        worst_mel = worst_wav = 0.0
        lengths, drifts = [], {}
        with torch.no_grad():
            for key in ("short", "medium"):
                text = VITS_SENTENCES[key]
                g, w = synthesis(model, text), synthesis(cpu_synth.tts_model, text)
                g_len, w_len = g["outputs"]["mel_lengths"].cpu(), w["outputs"]["mel_lengths"]
                if not torch.equal(g_len, w_len) or g["model_outputs"].shape != \
                        w["model_outputs"].shape:
                    raise AssertionError(f"Tacotron2 mel_lengths card {g_len.tolist()} != CPU "
                                         f"{w_len.tolist()} for {key!r}")
                drifts[key] = drift_per_steps(g["model_outputs"], w["model_outputs"], model.r)
                err = max(drifts[key])
                if not err <= T2_TOL or not np.isfinite(g["model_outputs"]).all():
                    raise AssertionError(f"Tacotron2 mel card vs CPU ({key}): max abs diff {err}; "
                                         f"per 100 steps {drifts[key]}")
                gw, ww = synth._vocode(g["model_outputs"]), cpu_synth._vocode(w["model_outputs"])
                werr = float(np.abs(gw - ww).max()) if gw.shape == ww.shape else np.inf
                if not werr <= T2_TOL or not np.isfinite(gw).all() or gw.std() == 0:
                    raise AssertionError(f"Tacotron2 + HiFiGAN card vs CPU ({key}): {gw.shape} vs "
                                         f"{ww.shape}, max abs diff {werr}")
                worst_mel, worst_wav = max(worst_mel, err), max(worst_wav, werr)
                lengths.append(int(g_len[0]))
        log(f"Tacotron2 + HiFiGAN card vs CPU, the short and medium sentences at their whole "
            f"budgets: mel_lengths {lengths} equal, mel max abs diff {worst_mel:.3g}, waveform "
            f"{worst_wav:.3g} (tol {T2_TOL}); mel max abs diff per 100 decode steps: "
            + "; ".join(f"{k} " + ", ".join(f"{v:.2g}" for v in vs) for k, vs in drifts.items())
            + f" (phase 11 at {time.time() - t_phase:.0f} s)")
        del cpu_synth

        # the DCA recipe, card against CPU on the short sentence
        dca = random_tacotron2(dca_config, seed=0)
        dca_cpu_state = {k: v.clone() for k, v in dca.module.state_dict().items()}
        with torch.no_grad():
            w = synthesis(dca, short)
            dca.load_state_dict({k: v.to(device) for k, v in dca_cpu_state.items()})
            g = synthesis(dca, short)
        derr = float(np.abs(g["model_outputs"] - w["model_outputs"]).max()) \
            if g["model_outputs"].shape == w["model_outputs"].shape else np.inf
        if not derr <= T2_TOL or not np.isfinite(g["model_outputs"]).all():
            raise AssertionError(f"Tacotron2-DCA card vs CPU: {g['model_outputs'].shape} vs "
                                 f"{w['model_outputs'].shape}, max abs diff {derr}")
        log(f"Tacotron2-DCA (LJSpeech DCA recipe: r {dca.r}, {dca.config.attention_type}, "
            f"{dca.config.audio.log_func}, no signal norm; seed 0), short sentence card vs CPU: "
            f"mel_lengths {int(g['outputs']['mel_lengths'][0])} equal, mel max abs diff "
            f"{derr:.3g} (tol {T2_TOL})")
        del dca, dca_cpu_state

        # B = 4 rows against their own B = 1 decodes at the same max_steps
        rows = list(VITS_SENTENCES.values()) + [MULTI_SENTENCES["en"]]
        with torch.no_grad():
            x, xl = t2_ids(model, rows, device)
            batch = model.inference(x, xl, max_steps=T2_B4_STEPS)
            b4err = 0.0
            for i, text in enumerate(rows):
                xi, xli = t2_ids(model, [text], device)
                one = model.inference(xi, xli, max_steps=T2_B4_STEPS)
                if int(one["mel_lengths"][0]) != int(batch["mel_lengths"][i]):
                    raise AssertionError(f"B=4 row {i}: mel_lengths {batch['mel_lengths'][i]} "
                                         f"vs {one['mel_lengths'][0]} alone")
                b4err = max(b4err, float((batch["model_outputs"][i] - one["model_outputs"][0])
                                         .abs().max()))
        if not b4err <= T2_TOL:
            raise AssertionError(f"Tacotron2 B=4 rows vs their B=1 decodes: max abs diff {b4err}")
        log(f"Tacotron2 B=4 ({[int(v) for v in xl]} tokens padded to {x.shape[1]}), each row "
            f"against its own B=1 decode at {T2_B4_STEPS} steps: mel_lengths equal, mel max abs "
            f"diff {b4err:.3g} (tol {T2_TOL}; phase 11 at {time.time() - t_phase:.0f} s)")

        # the stopnet firing at step 1: the decode leaves at the first check
        stopper = random_tacotron2(t2_config, seed=0, stop_bias=10.0)
        stopper.load_state_dict({k: v.to(device) for k, v in
                                 stopper.module.state_dict().items()})
        stopper.set_r(T2_DECODE_R)
        with torch.no_grad():
            x1, xl1 = t2_ids(stopper, [medium], device)
            out = stopper.inference(x1, xl1, max_steps=1000)
            early_ms = median_ms(lambda: stopper.inference(x1, xl1, max_steps=1000), device)[0]
        ran = out["alignments"].shape[1]
        if int(out["mel_lengths"][0]) != T2_DECODE_R or ran != t2_model.STOP_CHECK_EVERY:
            raise AssertionError(f"early exit: mel_lengths {out['mel_lengths'].tolist()}, "
                                 f"{ran} steps run")
        log(f"Tacotron2 stopnet firing at step 1 (bias +10): mel_lengths {T2_DECODE_R}, "
            f"{ran} of 1000 steps run (the first stop check), {early_ms:.1f} ms | {card}")
        del stopper

        # speed: ms per step, kernels per step, natural length and whole budget
        if cuda:
            step1 = t2_step_ms(model, [medium], device)
            step4 = t2_step_ms(model, rows, device)
            k1, d1 = t2_kernels_per_step(model, [medium], device, card)
            k4, d4 = t2_kernels_per_step(model, rows, device, card)
            log(f"Tacotron2 decode step (wall: slope between 100 and 300 steps, median of 3; "
                f"kernels and device time: profiled 150 less 50 steps): B=1 {step1:.3f} ms wall, "
                f"{k1:.1f} kernels, {d1 * 1e3:.1f} us device; B=4 {step4:.3f} ms wall, "
                f"{k4:.1f} kernels, {d4 * 1e3:.1f} us device | {card}")
        sr = synth.output_sample_rate
        for key, text in VITS_SENTENCES.items():
            n_tokens = len(model.tokenizer.text_to_ids(text))
            steps = min(3 * n_tokens, _frame_budget(n_tokens) // model.r)
            xk, xlk = t2_ids(model, [text], device)
            parts = {}

            def natural():
                t0 = time.perf_counter()
                with torch.no_grad():
                    o = model.inference(xk, xlk, max_steps=steps)
                    mel = o["model_outputs"][0, : int(o["mel_lengths"][0])].float().cpu().numpy()
                t1 = time.perf_counter()
                wav = synth._vocode(mel)
                sync(device)
                parts.update(model=(t1 - t0) * 1e3, vocoder=(time.perf_counter() - t1) * 1e3,
                             seconds=len(wav) / sr)

            ms, lo, hi = median_ms(natural, device, reps=3)
            samples = []
            full, flo, fhi = median_ms(lambda: samples.append(len(silent(synth.tts, text))),
                                       device, reps=1)
            full_s = (samples[-1] - SENTENCE_GAP * len(split_into_sentences(text))) / sr
            log(f"Tacotron2 + HiFiGAN {key} ({n_tokens} tokens): natural length ({steps} steps, "
                f"3 a token) {parts['seconds']:.2f} s of audio in {ms:.1f} ms (median of 3; "
                f"{lo:.1f}-{hi:.1f}), RTF {parts['seconds'] / ms * 1e3:.1f}, HiFiGAN "
                f"{parts['vocoder']:.1f} ms ({100 * parts['vocoder'] / ms:.1f} %); whole budget "
                f"through Synthesizer.tts {full_s:.2f} s in {full:.1f} ms (one call), RTF "
                f"{full_s / full * 1e3:.1f} | {card}")
        if cuda:
            n_tokens = len(model.tokenizer.text_to_ids(medium))
            xm, xlm = t2_ids(model, [medium], device)

            def natural_medium():
                with torch.no_grad():
                    o = model.inference(xm, xlm, max_steps=3 * n_tokens)
                    synth._vocode(o["model_outputs"][0, : int(o["mel_lengths"][0])].cpu().numpy())

            profile_call(natural_medium, "Tacotron2 + HiFiGAN, medium sentence at natural length",
                         card)
            st = t2_stage_ms(synth, medium, 3 * n_tokens, device)
            log(f"Tacotron2 + HiFiGAN stages, medium sentence at natural length ({3 * n_tokens} "
                f"steps), ms (median of 5; postnet and HiFiGAN by CUDA events, the rest by the "
                f"host clock): " + ", ".join(f"{k} {v:.2f}" for k, v in st.items()) + f" | {card}")

        # the zoo by name: reference-layout directories, nothing fetched
        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            zt = os.path.join(home, "tts_tpu", ZOO_T2.replace("/", "--"))
            zv = os.path.join(home, "tts_tpu", ZOO_HIFIGAN_V2.replace("/", "--"))
            shutil.copytree(t2_dir, zt)
            shutil.copytree(voc_dir, zv)
            by_name = TTS(model_name=ZOO_T2, device=device)
            by_path = TTS(model_path=t2_args[1], config_path=t2_args[3], vocoder_path=voc_args[1],
                          vocoder_config_path=voc_args[3], device=device)
            a = np.asarray(silent(by_name.tts, short), np.float32)
            b = np.asarray(silent(by_path.tts, short), np.float32)
            zerr = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
            if zerr != 0 or a.std() == 0 or by_name.synthesizer.tts_model.r != T2_DECODE_R:
                raise AssertionError(f"TTS(model_name={ZOO_T2}) vs path load: {a.shape} vs "
                                     f"{b.shape}, max abs diff {zerr}")
            log(f"zoo: {ZOO_T2} with its default vocoder {ZOO_HIFIGAN_V2} from reference-layout "
                f"directories, nothing fetched; r {by_name.synthesizer.tts_model.r}; the short "
                f"sentence differs from the path load by {zerr}")
            del by_name, by_path

        # the command line with the vocoder flags against the API
        api = TTS(model_path=t2_args[1], config_path=t2_args[3], vocoder_path=voc_args[1],
                  vocoder_config_path=voc_args[3], device=device)
        api_path, cli_path = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
        silent(api.tts_to_file, short, file_path=api_path)
        silent(synthesize_cli, ["--text", short, "--out_path", cli_path, "--device",
                                str(device)] + t2_args + voc_args)
        (api_sr, api_pcm), (cli_sr, cli_pcm) = (scipy.io.wavfile.read(p) for p in
                                                (api_path, cli_path))
        step = (np.abs(cli_pcm.astype(np.int32) - api_pcm.astype(np.int32)).max()
                if cli_pcm.shape == api_pcm.shape else None)
        if step is None or step > 1 or cli_sr != api_sr:
            raise AssertionError(f"tts --vocoder_path {cli_pcm.shape} at {cli_sr} Hz vs the API "
                                 f"{api_pcm.shape} at {api_sr} Hz: {step} int16 steps")
        log(f"tts --model_path --config_path --vocoder_path --vocoder_config_path (Tacotron2): "
            f"{len(cli_pcm)} samples at {cli_sr} Hz, at most {step} int16 step from "
            f"TTS.tts_to_file")
        del api

        # the server with the vocoder flags and --max_batch 4: served serially
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            srv = server_from_args(build_parser().parse_args(
                t2_args + voc_args + ["--max_batch", "4", "--port", "0",
                                      "--device", str(device)]))
        if "serving serially" not in said.getvalue() or srv.batcher is not None:
            raise AssertionError(f"Tacotron2 server with --max_batch 4: {said.getvalue()!r}")
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        results: dict = {}
        try:
            t1 = time.perf_counter()
            clients = [threading.Thread(target=_fetch, args=(
                f"{base}/api/tts?text={urllib.parse.quote(t)}", results, k))
                for k, t in (("short", short), ("medium", medium))]
            with contextlib.redirect_stdout(io.StringIO()):
                for cl in clients:
                    cl.start()
                for cl in clients:
                    cl.join(timeout=600)
            served_s = time.perf_counter() - t1
        finally:
            close_server(srv)
            thread.join(timeout=60)
        served_audio = 0.0
        for key in ("short", "medium"):
            res = results.get(key) or {}
            if res.get("status") != 200:
                raise AssertionError(f"Tacotron2 /api/tts {key!r}: {res.get('status')}")
            rate, pcm = scipy.io.wavfile.read(io.BytesIO(res["body"]))
            if rate != sr or len(pcm) <= SENTENCE_GAP or pcm[:-SENTENCE_GAP].std() < 30:
                raise AssertionError(f"Tacotron2 /api/tts {key!r}: {rate} Hz, {len(pcm)} samples")
            served_audio += len(pcm) / rate
        line = [ln for ln in said.getvalue().splitlines() if "serially" in ln][0].strip()
        log(f"Tacotron2 server (--vocoder_path, --max_batch 4): said {line!r}; 2 concurrent "
            f"/api/tts requests, {served_audio:.2f} s of audio in {served_s:.2f} s | {card}")
        del synth, model

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the Tacotron2 phase")
    line = "Tacotron2 + HiFiGAN: no hand-written kernel on this path (decode_attention launches 0)"
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 11 took {time.time() - t_phase:.1f} s | {card}")


ZOO_YOURTTS = "tts_models/multilingual/multi-dataset/your_tts"
ZOO_FAST_PITCH = "tts_models/en/ljspeech/fast_pitch"
ENCODER_TOL = 1e-4  # card vs CPU, the d-vectors, fp32 with TF32 off
FP_TOL = 1e-4  # card vs CPU, the ForwardTTS mel and waveform, fp32 with TF32 off
ENCODER_CLIP_S = (3.0, 10.0)
YOURTTS_SPEAKERS = ("p225", "p226", "p227", "p228")
TRAINER_DISK = "/published/yourtts"  # where a trainer's config names the encoder's files


def resnet_encoder_recipe_config():
    """``recipes/vctk/resnet_speaker_encoder/train_encoder.py:34-53``: the
    SE-ResNet34 of 64 mels with ``log_input`` and 512-wide d-vectors, its
    audio at 16 kHz, FFT 512, window 400, hop 160, pre-emphasis 0.97 (which
    the features of both packages skip, F25), no trim, RMS normalisation to
    -27 dB."""
    from tts_tpu_torch.encoder.configs import SpeakerEncoderConfig

    config = SpeakerEncoderConfig(model_params={"model_name": "resnet", "input_dim": 64,
                                                "log_input": True, "proj_dim": 512},
                                  voice_len=2.0)
    for k, v in dict(fft_size=512, win_length=400, hop_length=160, sample_rate=16000,
                     preemphasis=0.97, num_mels=64, mel_fmax=8000.0, do_trim_silence=False,
                     signal_norm=False, do_rms_norm=True, db_level=-27.0).items():
        setattr(config.audio, k, v)
    return config


def lstm_encoder_config():
    """The ``BaseEncoderConfig`` defaults: 3 LSTMs of 768 over 80 mels,
    projected to 256; the ``BaseAudioConfig`` defaults (22.05 kHz, FFT
    1024, hop 256)."""
    from tts_tpu_torch.encoder.configs import SpeakerEncoderConfig

    return SpeakerEncoderConfig()


def yourtts_recipe_config(d_vector_file: str):
    """``recipes/vctk/yourtts/train_yourtts.py:32-48``: VITS on graphemes
    with ``multilingual_cleaners``, 512-wide d-vectors (set on the top level
    and on ``model_args``), the speaker-encoder loss on, the ``VitsArgs``
    defaults otherwise; the speakers' mean d-vectors from
    ``d_vector_file``."""
    from tts_tpu_torch.models.vits import VitsConfig

    config = VitsConfig(text_cleaner="multilingual_cleaners", use_phonemes=False,
                        compute_linear_spec=True, return_wav=True, use_d_vector_file=True,
                        d_vector_file=d_vector_file)
    a = config.model_args
    a.num_chars, a.use_d_vector_file, a.d_vector_dim = None, True, 512
    a.use_speaker_encoder_as_loss, a.d_vector_file = True, d_vector_file
    a.speaker_encoder_model_path = f"{TRAINER_DISK}/model_se.pth.tar"
    a.speaker_encoder_config_path = f"{TRAINER_DISK}/config_se.json"
    return config


def fast_pitch_recipe_config():
    """``recipes/ljspeech/fast_pitch/train_fast_pitch.py:23-36``: the
    ``FastPitchConfig`` defaults (hidden 384, 6 + 6 FFT layers of one head,
    FFN 1024, pitch predictor, positional encoding), ``english_cleaners``
    with ``en-us`` phonemes from the rule G2P."""
    from tts_tpu_torch.models.forward_tts import FastPitchConfig

    return FastPitchConfig(text_cleaner="english_cleaners", use_phonemes=True,
                           phoneme_language="en-us")


def manifest_state(manifest: dict, seed: int) -> dict:
    """A reference-layout state dict rebuilt from a fixture's manifest, as
    ``tests/helpers.py:synth_state_from_manifest`` rebuilds it."""
    rs = np.random.RandomState(seed)
    state = {}
    for name, (shape, dtype) in manifest.items():
        shape = tuple(shape)
        if name.endswith("num_batches_tracked"):
            state[name] = np.zeros(shape, np.int64)
        elif name.endswith("running_var"):
            state[name] = (0.5 + np.abs(rs.randn(*shape))).astype(np.float32)
        elif name.endswith("running_mean"):
            state[name] = (0.1 * rs.randn(*shape)).astype(np.float32)
        else:
            state[name] = (0.1 * rs.randn(*shape)).astype(dtype)
    return state


def speaker_fidelity(device) -> str:
    """``speaker_encoder_resnet.npz`` and ``fastpitch.npz`` through the
    port's reference loaders on ``device``, at ``test_fidelity_corpus``'s
    thresholds (cosine above 0.9999; the frame count, mel RMSE under
    5e-3)."""
    import torch

    from tts_tpu_torch.encoder.configs import SpeakerEncoderConfig
    from tts_tpu_torch.encoder.model import SpeakerEncoder
    from tts_tpu_torch.models.forward_tts import FastPitchConfig, ForwardTTS
    from tts_tpu_torch.utils.convert import load_reference_forward_tts, load_reference_speaker_encoder

    def fixture(name):
        npz = np.load(os.path.join(REPO, "tests", "fixtures", "fidelity", f"{name}.npz"))
        meta = json.loads(bytes(npz["meta"]).decode())
        state = manifest_state(meta["state_manifest"], meta["state_seed"]) \
            if "state_manifest" in meta else \
            {k[3:]: npz[k] for k in npz.files if k.startswith("sd/")}
        ins = {k[3:]: npz[k] for k in npz.files if k.startswith("in/")}
        outs = {k[4:]: npz[k] for k in npz.files if k.startswith("out/")}
        return state, ins, outs, meta

    state, ins, outs, meta = fixture("speaker_encoder_resnet")
    config = SpeakerEncoderConfig(model_params={"model_name": "resnet", "log_input": True,
                                                "input_dim": meta["input_dim"],
                                                "proj_dim": meta["proj_dim"]})
    enc = SpeakerEncoder(config).load_state_dict(load_reference_speaker_encoder(state, config))
    enc.module.to(device)
    with torch.no_grad():
        ours = enc.module(torch.from_numpy(ins["mel"].transpose(0, 2, 1)).to(device))
    ours = ours.float().cpu().numpy()
    ref = outs["emb"]
    cos = np.sum(ref * ours, -1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(ours, axis=-1))
    if not np.all(cos > 0.9999):
        raise AssertionError(f"speaker_encoder_resnet.npz on {device}: cosine {cos}")

    state, ins, outs, meta = fixture("fastpitch")
    fp = FastPitchConfig()
    a = fp.model_args
    a.num_chars, a.out_channels, a.hidden_channels = 40, 20, 32
    a.duration_predictor_hidden_channels = a.pitch_predictor_hidden_channels = 48
    a.encoder_params = a.decoder_params = {"hidden_channels_ffn": 64, "num_heads": 2,
                                           "num_layers": 2, "dropout_p": 0.0}
    model = ForwardTTS(fp)
    model.load_state_dict({k: v.to(device) for k, v in
                           load_reference_forward_tts(state, a).items()})
    with torch.no_grad():
        out = model.inference(torch.from_numpy(ins["text"]).long().to(device),
                              torch.from_numpy(ins["text_lengths"]).long().to(device),
                              max_frames=64)
    T = int(out["y_lengths"][0])
    mel = out["model_outputs"][0, :T].float().cpu().numpy()
    rmse = float(np.sqrt(np.mean((mel - outs["mel"][0]) ** 2))) if T == len(outs["mel"][0]) \
        else np.inf
    if not rmse < FIDELITY_RMSE:
        raise AssertionError(f"fastpitch.npz on {device}: {T} frames, mel RMSE {rmse}")
    return (f"speaker_encoder_resnet.npz cosine {float(cos.min()):.7f} (> 0.9999), max abs diff "
            f"{float(np.abs(ours - ref).max()):.3g}; fastpitch.npz {T} frames as the reference, "
            f"mel RMSE {rmse:.3g} (< {FIDELITY_RMSE})")


def fast_pitch_stage_ms(synth, text: str, device, reps: int = 5) -> dict:
    """One sentence's stages on the card, medians of ``reps``: the encoder
    with the durations and the pitch adaptor, the expansion, the decoder and
    HiFiGAN by CUDA events; the host bridge by the host clock."""
    import torch

    from tts_tpu_torch.utils.synthesis import _frame_budget

    model = synth.tts_model
    m = model.module
    ids = model.tokenizer.text_to_ids(text)
    T = ((len(ids) + 15) // 16) * 16
    x = torch.zeros(1, T, dtype=torch.long, device=device)
    x[0, : len(ids)] = torch.tensor(ids, device=device)
    xl = torch.tensor([len(ids)], device=device)
    budget = _frame_budget(len(ids))
    runs: dict = {}
    with torch.no_grad():
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            e = m.encode(x, xl, max_frames=budget)
            ev[1].record()
            o_en_ex, _ = m._expand(e["o_en"], e["durations"], e["x_mask"], e["y_mask"])
            ev[2].record()
            y = m._decode(o_en_ex, e["y_mask"])
            ev[3].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = int(e["y_lengths"][0])
            mel = y[0, :frames].float().cpu().numpy()
            voc_in = synth.vocoder_ap.normalize(synth.ap.denormalize(mel.T))
            c = torch.from_numpy(np.ascontiguousarray(voc_in.T[None], np.float32)).to(device)
            torch.cuda.synchronize()
            bridge = (time.perf_counter() - t0) * 1e3
            ev[4].record()
            synth.vocoder_model.inference(c)
            ev[5].record()
            torch.cuda.synchronize()
            times = {"encoder + durations + pitch": ev[0].elapsed_time(ev[1]),
                     "expansion": ev[1].elapsed_time(ev[2]),
                     "decoder": ev[2].elapsed_time(ev[3]), "host bridge": bridge,
                     "HiFiGAN": ev[4].elapsed_time(ev[5])}
            for k, v in times.items():
                runs.setdefault(k, []).append(v)
    return {"times": {k: sorted(v)[reps // 2] for k, v in runs.items()}, "frames": frames,
            "budget": budget, "tokens": len(ids)}


def _int16_steps(a_path: str, b_path: str):
    """The largest difference of two wav files in int16 steps (``None`` when
    their shapes or rates differ), and the first file's rate."""
    import scipy.io.wavfile

    (sa, a), (sb, b) = (scipy.io.wavfile.read(p) for p in (a_path, b_path))
    if a.shape != b.shape or sa != sb:
        return None, sa
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()), sa


def _serve_once(args: list, query: dict, device) -> tuple:
    """The server from its command line (``args``, with ``--max_batch 4``) on
    a free port answering one ``/api/tts`` request: ``(status, body, what it
    said at start-up, the batch sizes its batcher dispatched)``."""
    import io

    from tts_tpu_torch.server.server import build_parser, close_server, server_from_args

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        srv = server_from_args(build_parser().parse_args(
            args + ["--max_batch", "4", "--port", "0", "--device", str(device)]))
    dispatched = []
    if srv.batcher is not None:
        real = srv.batcher._dispatch
        srv.batcher._dispatch = lambda batch: dispatched.append(len(batch)) or real(batch)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    out: dict = {}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _fetch(f"http://127.0.0.1:{srv.server_address[1]}/api/tts?"
                   + urllib.parse.urlencode(query), out, "r")
    finally:
        close_server(srv)
        thread.join(timeout=60)
    return out["r"]["status"], out["r"]["body"], said.getvalue(), dispatched


def phase_speaker_and_forward_tts(card: str, device="cuda", cut=None) -> None:
    """The speaker encoders, YourTTS voice cloning and the ForwardTTS family
    at the recipes' widths, fp32 weights from seed 0: both fidelity
    fixtures on the card; the ResNet and LSTM encoders card against CPU on
    3 s and 10 s clips (d-vectors within 1e-4, finite) and their ms per
    clip; YourTTS ``speaker_wav`` → waveform card against CPU on host noise,
    the encoder's share of a cloned request and its latency against a named
    speaker's, then ``TTS(encoder_path=...)``, ``tts --encoder_path`` within
    one int16 step, the server's ``/api/tts?speaker_wav=`` on the serial
    path, and ``your_tts`` by zoo name loading its directory's encoder
    (F23); FastPitch with HiFiGAN card against CPU on the three phase 6
    sentences (mel and waveform within 1e-4), FastSpeech2 and SpeedySpeech
    on the short one, latency, RTF and the stage split, busy share and
    kernels, ``fast_pitch`` by zoo name with ``hifigan_v2`` against the path
    load, the command line and the server (serial). ``decode_attention``
    must not launch. ``cut(resnet, lstm, yourtts, fast_pitch, hifigan)``
    shrinks the configs in place, for rehearsals on the CPU."""
    import io
    import shutil

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.encoder.model import SpeakerEncoder, load_speaker_encoder
    from tts_tpu_torch.models.forward_tts import (
        Fastspeech2Config,
        ForwardTTS,
        SpeedySpeechConfig,
    )
    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.utils.convert import (
        reference_forward_tts_state,
        reference_speaker_encoder_state,
        reference_vits_state,
    )
    from tts_tpu_torch.utils.synthesis import synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda *configs: None)
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    short, medium = VITS_SENTENCES["short"], VITS_SENTENCES["medium"]

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    log(f"speaker encoder and FastPitch fidelity replays on {device}: "
        + speaker_fidelity(device) + f" | {card}")

    with tempfile.TemporaryDirectory() as d:
        speakers_file = os.path.join(d, "speakers.json")
        configs = (resnet_encoder_recipe_config(), lstm_encoder_config(),
                   yourtts_recipe_config(speakers_file), fast_pitch_recipe_config(),
                   hifigan_recipe_config())
        cut(*configs)
        resnet_cfg, lstm_cfg, yt_cfg, fp_cfg, voc_cfg = configs
        # two clips a speaker, their d-vectors of length ~1.1: a mean d-vector is no unit vector
        rs = np.random.RandomState(0)
        dim = yt_cfg.model_args.d_vector_dim
        write_json(speakers_file, {f"{name}_{i}.wav": {"name": name, "embedding": (
            rs.randn(dim) * 0.05).tolist()} for name in YOURTTS_SPEAKERS for i in range(2)})

        # the encoders: reference-layout files, card against CPU, ms per clip
        encoder_files = {}
        for kind, config in (("resnet", resnet_cfg), ("lstm", lstm_cfg)):
            enc = SpeakerEncoder(config).init_params(seed=0, device="cpu")
            n_params = sum(p.numel() for p in enc.module.parameters())
            se_dir = os.path.join(d, f"se_{kind}")
            os.makedirs(se_dir)
            files = (os.path.join(se_dir, "model_se.pth.tar"),
                     os.path.join(se_dir, "config_se.json"))
            torch.save({"model": {k: torch.from_numpy(v) for k, v in
                                  reference_speaker_encoder_state(enc.module.state_dict()).items()}},
                       files[0])
            write_json(files[1], config.to_dict())
            encoder_files[kind] = files
            on_card, ap = load_speaker_encoder(*files, device=device)
            on_cpu, _ = load_speaker_encoder(*files, device="cpu")
            worst, timings = 0.0, []
            for seconds in ENCODER_CLIP_S:
                wav = reference_wav(seconds, sr=ap.sample_rate, seed=int(seconds))
                got = on_card.compute_embedding_from_wav(wav)
                want = on_cpu.compute_embedding_from_wav(wav)
                err = float(np.abs(got - want).max())
                if not np.isfinite(got).all() or not err <= ENCODER_TOL:
                    raise AssertionError(f"{kind} encoder card vs CPU on {seconds} s: max abs "
                                         f"diff {err} (finite: {np.isfinite(got).all()})")
                worst = max(worst, err)
                frames = on_card.features(wav).shape[1]
                windows = 1 if frames <= 250 else len(range(0, frames - 250 + 1, 125))
                ms, lo, hi = median_ms(lambda: on_card.compute_embedding_from_wav(wav), device)
                timings.append(f"{seconds:g} s ({frames} frames, {windows} window"
                               f"{'s' if windows > 1 else ''}) {ms:.2f} ms ({lo:.2f}-{hi:.2f})")
            mp = config.model_params
            log(f"{kind} speaker encoder ({mp}; {ap.sample_rate} Hz, hop {ap.hop_length}; "
                f"{n_params / 1e6:.2f} M parameters, seed 0): card vs CPU d-vectors max abs diff "
                f"{worst:.3g} (tol {ENCODER_TOL}), finite; ms per clip (median of 5, the "
                f"features included): " + ", ".join(timings) + f" | {card}")
            if cuda and kind == "resnet":
                wav10 = reference_wav(ENCODER_CLIP_S[-1], sr=ap.sample_rate, seed=10)
                profile_call(lambda: on_card.compute_embedding_from_wav(wav10),
                             "ResNet speaker encoder, one 10 s clip", card)
            del on_card, on_cpu, enc

        # YourTTS: speaker_wav → d-vector → VITS, card against CPU on host noise
        yt_dir = os.path.join(d, "yourtts")
        os.makedirs(yt_dir)
        yt = Vits.init_from_config(yt_cfg).init_params(seed=0, device="cpu")
        n_yt = sum(p.numel() for p in yt.module.parameters())
        yt_state = yt.module.state_dict()
        torch.save(yt_state, os.path.join(yt_dir, "model_torch.pt"))
        write_json(os.path.join(yt_dir, "config.json"), yt.config.to_dict())
        del yt
        ref_wav = os.path.join(d, "ref.wav")
        scipy.io.wavfile.write(ref_wav, 22050, reference_wav(3.0, seed=7))
        yt_args = ["--model_path", os.path.join(yt_dir, "model_torch.pt"), "--config_path",
                   os.path.join(yt_dir, "config.json")]
        enc_args = ["--encoder_path", encoder_files["resnet"][0], "--encoder_config_path",
                    encoder_files["resnet"][1]]

        def load_yt(dev):
            return Synthesizer(tts_checkpoint=yt_args[1], tts_config_path=yt_args[3], device=dev,
                               encoder_checkpoint=enc_args[1], encoder_config=enc_args[3])

        synth, cpu_synth = load_yt(device), load_yt("cpu")
        a = synth.tts_config.model_args
        got_dv = np.asarray(synth.tts_model.speaker_manager.compute_embedding_from_clip(ref_wav))
        want_dv = np.asarray(cpu_synth.tts_model.speaker_manager.compute_embedding_from_clip(
            ref_wav))
        with torch.no_grad():
            wav, err, y_lengths, _ = silent(card_against_cpu, synth, cpu_synth, short,
                                            speaker_wav=ref_wav)
        log(f"YourTTS (recipe: {synth.tts_config.text_cleaner}, graphemes, num_chars "
            f"{a.num_chars}, {a.d_vector_dim}-wide d-vectors, {n_yt / 1e6:.2f} M parameters, "
            f"seed 0) cloning a 3 s clip: d-vector card vs CPU {float(np.abs(got_dv - want_dv).max()):.3g}"
            f", finite; the short sentence card vs CPU on host noise: y_lengths {y_lengths} "
            f"equal, waveform max abs diff {err:.3g} (tol {VITS_WAV_TOL})")
        del cpu_synth
        sm = synth.tts_model.speaker_manager
        enc_ms, _, _ = median_ms(lambda: sm.compute_embedding_from_clip(ref_wav), device)
        silent(synth.tts, medium, speaker_wav=ref_wav)
        cloned_ms, lo, hi = median_ms(lambda: silent(synth.tts, medium, speaker_wav=ref_wav),
                                      device)
        named_ms, nlo, nhi = median_ms(lambda: silent(synth.tts, medium, speaker_name="p226"),
                                       device)
        log(f"YourTTS medium sentence: cloned from the 3 s clip {cloned_ms:.1f} ms ({lo:.1f}-"
            f"{hi:.1f}), of which the encoder (clip load, features, ResNet) {enc_ms:.1f} ms "
            f"({100 * enc_ms / cloned_ms:.1f} %); with the named speaker p226 {named_ms:.1f} ms "
            f"({nlo:.1f}-{nhi:.1f}); medians of 5 | {card}")
        if cuda:
            profile_call(lambda: silent(synth.tts, medium, speaker_wav=ref_wav),
                         "YourTTS, one medium sentence cloned from a 3 s clip", card)

        # TTS(encoder_path=...), tts --encoder_path, the server's speaker_wav
        api = TTS(model_path=yt_args[1], config_path=yt_args[3], encoder_path=enc_args[1],
                  encoder_config_path=enc_args[3], device=device)
        api_path, cli_path = os.path.join(d, "yt_api.wav"), os.path.join(d, "yt_cli.wav")
        silent(api.tts_to_file, short, speaker_wav=ref_wav, file_path=api_path)
        silent(synthesize_cli, ["--text", short, "--speaker_wav", ref_wav, "--out_path", cli_path,
                                "--device", str(device)] + yt_args + enc_args)
        step, sr = _int16_steps(cli_path, api_path)
        if step is None or step > 1:
            raise AssertionError(f"tts --encoder_path vs the API: {step} int16 steps")
        del api
        status, body, said, dispatched = _serve_once(yt_args + enc_args,
                                                     {"text": short, "speaker_wav": ref_wav},
                                                     device)
        pcm = scipy.io.wavfile.read(io.BytesIO(body))[1] if status == 200 else None
        api_pcm = scipy.io.wavfile.read(api_path)[1]
        serr = (int(np.abs(pcm.astype(np.int32) - api_pcm).max())
                if pcm is not None and pcm.shape == api_pcm.shape else None)
        if status != 200 or dispatched or serr is None or serr > 1:
            raise AssertionError(f"YourTTS /api/tts?speaker_wav=: {status}, dispatched "
                                 f"{dispatched}, {serr} int16 steps from the API")
        log(f"YourTTS surfaces: TTS(encoder_path=...) and tts --encoder_path --speaker_wav "
            f"within {step} int16 step; the server (--encoder_path, --max_batch 4) answered "
            f"/api/tts?speaker_wav= on the serial path (batcher dispatches {dispatched}), "
            f"{serr} int16 steps from the API")

        # your_tts by zoo name: the directory's encoder, the config's paths rewritten (F23)
        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            zy = os.path.join(home, "tts_tpu", ZOO_YOURTTS.replace("/", "--"))
            os.makedirs(zy)
            reference = {k: torch.from_numpy(v) for k, v in reference_vits_state(yt_state).items()}
            se_state = torch.load(encoder_files["resnet"][0], weights_only=True)["model"]
            reference.update({"speaker_encoder." + k: v for k, v in se_state.items()})
            torch.save({"model": reference}, os.path.join(zy, "model_file.pth"))
            shutil.copy(speakers_file, os.path.join(zy, "speakers.json"))
            for f in encoder_files["resnet"]:
                shutil.copy(f, zy)
            saved = json.load(open(yt_args[3]))
            saved["d_vector_file"] = saved["model_args"]["d_vector_file"] = \
                f"{TRAINER_DISK}/speakers.json"
            write_json(os.path.join(zy, "config.json"), saved)
            by_name = TTS(model_name=ZOO_YOURTTS, device=device)
            by_path = TTS(model_path=os.path.join(zy, "model_file.pth"),
                          config_path=os.path.join(zy, "config.json"),
                          encoder_path=os.path.join(zy, "model_se.pth.tar"),
                          encoder_config_path=os.path.join(zy, "config_se.json"), device=device)
            rewritten = json.load(open(os.path.join(zy, "config.json")))["model_args"]
            if rewritten["speaker_encoder_model_path"] != os.path.join(zy, "model_se.pth.tar") \
                    or by_name.synthesizer.tts_model.speaker_manager.encoder is None:
                raise AssertionError(f"F23: {ZOO_YOURTTS} loaded no encoder from its directory "
                                     f"({rewritten['speaker_encoder_model_path']})")
            with host_noise(seed=0):
                za = np.asarray(silent(by_name.tts, short, speaker_wav=ref_wav), np.float32)
                zb = np.asarray(silent(by_path.tts, short, speaker_wav=ref_wav), np.float32)
            zerr = float(np.abs(za - zb).max()) if za.shape == zb.shape else np.inf
            if zerr != 0 or za.std() == 0:
                raise AssertionError(f"{ZOO_YOURTTS} by name vs path load: {za.shape} vs "
                                     f"{zb.shape}, max abs diff {zerr}")
            log(f"zoo: {ZOO_YOURTTS} from a reference-layout directory (model_file.pth with its "
                f"speaker_encoder.* dropped, speakers.json, model_se.pth.tar, config_se.json), "
                f"nothing fetched; the config's encoder paths rewritten from the trainer's and "
                f"the encoder loaded (F23); the cloned short sentence differs from the path "
                f"load by {zerr}")
            del by_name, by_path
        del synth

        # FastPitch with HiFiGAN: card against CPU, latency, stages
        fp_dir, voc_dir = os.path.join(d, "fp"), os.path.join(d, "voc")
        os.makedirs(fp_dir)
        os.makedirs(voc_dir)
        fp = ForwardTTS.init_from_config(fp_cfg).init_params(seed=0, device="cpu")
        n_fp = sum(p.numel() for p in fp.module.parameters())
        torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_forward_tts_state(
            fp.module.state_dict(), fp.module.pos_encoder.pe).items()}},
            os.path.join(fp_dir, "model_file.pth"))
        write_json(os.path.join(fp_dir, "config.json"), fp.config.to_dict())
        c = fp.config
        del fp
        gen = random_vocoder(voc_cfg, seed=0)
        torch.save({"model": {"model_g." + k: v for k, v in gen.state_dict().items()}},
                   os.path.join(voc_dir, "model_file.pth"))
        write_json(os.path.join(voc_dir, "config.json"), voc_cfg.to_dict())
        del gen
        fp_args = ["--model_path", os.path.join(fp_dir, "model_file.pth"), "--config_path",
                   os.path.join(fp_dir, "config.json")]
        voc_args = ["--vocoder_path", os.path.join(voc_dir, "model_file.pth"),
                    "--vocoder_config_path", os.path.join(voc_dir, "config.json")]

        def load_fp(dev):
            return Synthesizer(tts_checkpoint=fp_args[1], tts_config_path=fp_args[3],
                               vocoder_checkpoint=voc_args[1], vocoder_config=voc_args[3],
                               device=dev)

        synth, cpu_synth = load_fp(device), load_fp("cpu")
        worst_mel = worst_wav = 0.0
        lengths = []
        with torch.no_grad():
            for text in VITS_SENTENCES.values():
                g, w = synthesis(synth.tts_model, text), synthesis(cpu_synth.tts_model, text)
                g_len, w_len = g["outputs"]["y_lengths"].cpu(), w["outputs"]["y_lengths"]
                if not torch.equal(g_len, w_len):
                    m = synth.tts_model.module
                    x = g["text_inputs"]
                    x_mask = (g["outputs"]["durations"] > 0)[:, :, None].float()
                    raw = (torch.exp(m.duration_predictor(m._encode(x, x_mask), x_mask)[0, :, 0])
                           - 1).cpu().numpy()
                    raise AssertionError(f"FastPitch y_lengths card {g_len.tolist()} != CPU "
                                         f"{w_len.tolist()} for {text!r}; the durations nearest "
                                         f".5 before rounding: "
                                         f"{sorted(raw, key=lambda v: abs(v % 1 - 0.5))[:4]}")
                err = float(np.abs(g["model_outputs"] - w["model_outputs"]).max())
                gw, ww = synth._vocode(g["model_outputs"]), cpu_synth._vocode(w["model_outputs"])
                werr = float(np.abs(gw - ww).max()) if gw.shape == ww.shape else np.inf
                if not err <= FP_TOL or not werr <= FP_TOL or not np.isfinite(gw).all() \
                        or gw.std() == 0:
                    raise AssertionError(f"FastPitch + HiFiGAN card vs CPU: mel {err}, waveform "
                                         f"{werr} (tol {FP_TOL})")
                worst_mel, worst_wav = max(worst_mel, err), max(worst_wav, werr)
                lengths.append(int(g_len[0]))
        log(f"FastPitch (LJSpeech recipe, phonemes from "
            f"{synth.tts_model.tokenizer.phonemizer.name()}, num_chars {c.model_args.num_chars}:"
            f" hidden {c.model_args.hidden_channels}, {c.model_args.encoder_params['num_layers']}"
            f" + {c.model_args.decoder_params['num_layers']} FFT layers, FFN "
            f"{c.model_args.encoder_params['hidden_channels_ffn']}; {n_fp / 1e6:.2f} M "
            f"parameters, seed 0, duration bias for ~6 frames a token) + HiFiGAN card vs CPU, "
            f"the three phase 6 sentences: y_lengths {lengths} equal, mel max abs diff "
            f"{worst_mel:.3g}, waveform {worst_wav:.3g} (tol {FP_TOL})")
        for name, cls in (("FastSpeech2", Fastspeech2Config), ("SpeedySpeech", SpeedySpeechConfig)):
            cfg = cls(text_cleaner="english_cleaners", use_phonemes=True, phoneme_language="en-us")
            cut(None, None, None, cfg, None)
            m = ForwardTTS.init_from_config(cfg).init_params(seed=0, device="cpu")
            n_m = sum(p.numel() for p in m.module.parameters())
            cpu_out = synthesis(m, short)
            m.module.to(device)
            with torch.no_grad():
                card_out = synthesis(m, short)
            err = float(np.abs(card_out["model_outputs"] - cpu_out["model_outputs"]).max()) \
                if card_out["model_outputs"].shape == cpu_out["model_outputs"].shape else np.inf
            if not err <= FP_TOL or not np.isfinite(card_out["model_outputs"]).all():
                raise AssertionError(f"{name} card vs CPU on the short sentence: {err}")
            log(f"{name} (its config's defaults, {n_m / 1e6:.2f} M parameters, seed 0) card vs "
                f"CPU, the short sentence: {card_out['model_outputs'].shape[0]} frames each, mel "
                f"max abs diff {err:.3g} (tol {FP_TOL})")
            del m
        del cpu_synth

        silent(synth.tts, medium)
        for key, text in VITS_SENTENCES.items():
            ms, lo, hi = median_ms(lambda: silent(synth.tts, text), device)
            seconds = (len(silent(synth.tts, text)) - SENTENCE_GAP) / synth.output_sample_rate
            log(f"FastPitch + HiFiGAN {key}: {seconds:.2f} s of audio (after the trim) in "
                f"{ms:.1f} ms (median of 5; {lo:.1f}-{hi:.1f}), RTF {seconds / ms * 1e3:.1f} "
                f"| {card}")
        if cuda:
            st = fast_pitch_stage_ms(synth, medium, device)
            log(f"FastPitch stages, medium sentence ({st['tokens']} tokens, {st['frames']} frames,"
                f" budget {st['budget']}), ms (median of 5; CUDA events, the bridge by the host "
                f"clock): " + ", ".join(f"{k} {v:.2f}" for k, v in st["times"].items())
                + f" | {card}")
            profile_call(lambda: silent(synth.tts, medium),
                         "FastPitch + HiFiGAN, one medium sentence through Synthesizer.tts", card)

        # fast_pitch by zoo name with hifigan_v2, the command line, the server
        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            shutil.copytree(fp_dir, os.path.join(home, "tts_tpu",
                                                 ZOO_FAST_PITCH.replace("/", "--")))
            shutil.copytree(voc_dir, os.path.join(home, "tts_tpu",
                                                  ZOO_HIFIGAN_V2.replace("/", "--")))
            by_name = TTS(model_name=ZOO_FAST_PITCH, device=device)
            za = np.asarray(silent(by_name.tts, short), np.float32)
            zb = np.asarray(silent(synth.tts, short), np.float32)
            zerr = float(np.abs(za - zb).max()) if za.shape == zb.shape else np.inf
            if zerr != 0 or za.std() == 0 or by_name.synthesizer.vocoder_model is None:
                raise AssertionError(f"{ZOO_FAST_PITCH} by name vs path load: {za.shape} vs "
                                     f"{zb.shape}, max abs diff {zerr}")
            del by_name
        api = TTS(model_path=fp_args[1], config_path=fp_args[3], vocoder_path=voc_args[1],
                  vocoder_config_path=voc_args[3], device=device)
        api_path, cli_path = os.path.join(d, "fp_api.wav"), os.path.join(d, "fp_cli.wav")
        silent(api.tts_to_file, medium, file_path=api_path)
        silent(synthesize_cli, ["--text", medium, "--out_path", cli_path, "--device",
                                str(device)] + fp_args + voc_args)
        step, sr = _int16_steps(cli_path, api_path)
        if step is None or step > 1 or sr != voc_cfg.audio.sample_rate:
            raise AssertionError(f"FastPitch tts --vocoder_path vs the API: {step} int16 steps")
        del api
        status, body, said, _ = _serve_once(fp_args + voc_args, {"text": medium}, device)
        if status != 200 or "serving serially" not in said:
            raise AssertionError(f"FastPitch server: {status}, said {said!r}")
        pcm = scipy.io.wavfile.read(io.BytesIO(body))[1]
        serr = int(np.abs(pcm.astype(np.int32) - scipy.io.wavfile.read(api_path)[1]).max())
        log(f"FastPitch surfaces: {ZOO_FAST_PITCH} with {ZOO_HIFIGAN_V2} by name from "
            f"reference-layout directories, nothing fetched, {zerr} from the path load; tts "
            f"--vocoder_path within {step} int16 step of TTS.tts_to_file; the server "
            f"(--max_batch 4) serves serially, {serr} int16 steps from the API")
        del synth

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the speaker-encoder, YourTTS and ForwardTTS phase")
    line = ("speaker encoders, YourTTS, ForwardTTS: no hand-written kernel on these paths "
            "(decode_attention launches 0)")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 12 took {time.time() - t_phase:.1f} s | {card}")


ZOO_OVERFLOW = "tts_models/en/ljspeech/overflow"
ZOO_NEURAL_HMM = "tts_models/en/ljspeech/neural_hmm"
HMM_TOL = 1e-4  # card vs CPU, the mels and waveforms of phase 13, fp32 with TF32 off
HMM_NEVER = -20.0  # a transition bias that never fires: sigmoid(-20) is 2e-9
HMM_BIASES = (-3.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0)  # the calibration grid
HMM_PACE = 3.0  # LJSpeech's pace, frames a state
HMM_MEL_STATS = (-2.5, 1.75)  # stand-in mel statistics of the saved checkpoint (exact in fp32)
HMM_WAVE_KEYS = ("short", "medium")  # the sentences vocoded card against CPU
HMM_TIMING = (256, 768)  # frames between which ms per frame is the slope
HMM_PROFILE = (64, 192)  # frames between which kernels per frame are counted


def overflow_recipe_config():
    """``recipes/ljspeech/overflow/train_overflow.py:24-35``: the
    ``OverflowConfig`` defaults (512-wide encoder of 2 states a token, memory
    LSTM 1024, prenet 2 × 256, output net [1024], 12 post-flow blocks of 4
    WaveNet layers 150 wide), ``phoneme_cleaners``, ``en-us`` phonemes;
    ``norm_type="folded"``, as a converted checkpoint runs."""
    from tts_tpu_torch.models.overflow import OverflowConfig

    return OverflowConfig(text_cleaner="phoneme_cleaners", use_phonemes=True,
                          phoneme_language="en-us", norm_type="folded")


def neuralhmm_recipe_config():
    """``recipes/ljspeech/neuralhmm_tts/train_neuralhmmtts.py:24-52``: its
    audio (22.05 kHz, trimming, no signal normalisation, mels 0-8000 Hz,
    natural log, ``ref_level_db`` 20, no preemphasis), the
    ``NeuralhmmTTSConfig`` defaults, ``phoneme_cleaners``, ``en-us``
    phonemes; folded norms."""
    from tts_tpu_torch.config.shared import BaseAudioConfig
    from tts_tpu_torch.models.overflow import NeuralhmmTTSConfig

    audio = BaseAudioConfig(sample_rate=22050, do_trim_silence=True, trim_db=60.0,
                            signal_norm=False, mel_fmin=0.0, mel_fmax=8000, spec_gain=1.0,
                            log_func="np.log", ref_level_db=20, preemphasis=0.0)
    return NeuralhmmTTSConfig(audio=audio, text_cleaner="phoneme_cleaners", use_phonemes=True,
                              phoneme_language="en-us", norm_type="folded")


def align_tts_recipe_config():
    """``recipes/ljspeech/align_tts/train_aligntts.py:22-34``: graphemes with
    ``english_cleaners`` and the ``AlignTTSArgs`` defaults (hidden 256, 6 FFT
    layers of 2 heads a side)."""
    from tts_tpu_torch.models.align_tts import AlignTTSConfig

    return AlignTTSConfig(text_cleaner="english_cleaners", use_phonemes=False,
                          phoneme_language="en-us")


def delightful_tts_recipe_config():
    """``recipes/ljspeech/delightful_tts/train_delightful_tts.py:22-39``:
    ``english_cleaners`` with ``en-us`` phonemes and the ``DelightfulTtsArgs``
    defaults (6 conformer layers of 512 and 8 heads a side, the joint HiFiGAN
    from 512 channels, upsampling [8, 8, 2, 2]), the embedding sized by the
    phoneme set (``num_chars`` None: the default 100 is below it, F7)."""
    from tts_tpu_torch.models.delightful_tts import DelightfulTTSConfig

    config = DelightfulTTSConfig(text_cleaner="english_cleaners", use_phonemes=True,
                                 phoneme_language="en-us")
    config.model_args.num_chars = None
    return config


def set_transition(model, bias: float) -> None:
    """The bias of the output net projection's last row, the transition
    logit (an Overflow or NeuralHMM wrapper)."""
    import torch

    with torch.no_grad():
        model.module.neural_hmm.output_net.proj.bias[-1] = bias


def decision_margin(out, threshold: float) -> float:
    """Smallest ``|p_move - threshold|`` over the decisions an HMM decode
    took: every step of a row up to and including the one that left its
    last state."""
    p = out["transitions"].float().cpu().numpy()
    steps = p.shape[1]
    return min(float(np.abs(p[b, : min(int(n) + 1, steps)] - threshold).min())
               for b, n in enumerate(out["y_lengths"].cpu()))


def calibrate_transition(model, text: str, device) -> tuple:
    """Try each bias of ``HMM_BIASES`` on ``text`` at its budget and keep the
    one whose decode leaves its last state at the pace nearest
    ``HMM_PACE`` frames a state, its decisions at least 1e-3 from the
    threshold. Returns ``(bias, pace, margin)`` and the grid's readings."""
    import torch

    from tts_tpu_torch.utils.synthesis import _frame_budget

    x, xl = t2_ids(model, [text], device)
    budget, states = _frame_budget(int(xl[0])), 2 * int(xl[0])
    grid = []
    with torch.no_grad():
        for bias in HMM_BIASES:
            set_transition(model, bias)
            out = model.inference(x, xl, max_frames=budget)
            y = int(out["y_lengths"][0])
            grid.append((bias, y / states, y < budget,
                         decision_margin(out, model.config.duration_threshold)))
    ended = [g for g in grid if g[2] and g[3] >= 1e-3]
    if not ended:
        raise AssertionError(f"no transition bias of {HMM_BIASES} ends the decode: {grid}")
    bias, pace, _, margin = min(ended, key=lambda g: abs(g[1] - HMM_PACE))
    set_transition(model, bias)
    return (bias, pace, margin), grid


def hmm_stage_ms(synth, text: str, device, reps: int = 5) -> dict:
    """One Overflow sentence's stages at its natural length, medians of
    ``reps``: the encoder, the sampling loop, the post-flow with the
    denormalisation and HiFiGAN by CUDA events, the host bridge (the mel to
    the host, the two audio processors, back to the card) by the host
    clock."""
    import torch

    from tts_tpu_torch.ops.helpers import sequence_mask
    from tts_tpu_torch.utils.synthesis import _frame_budget

    model = synth.tts_model
    m, c = model.module, model.config
    x, xl = t2_ids(model, [text], device)
    budget = _frame_budget(int(xl[0]))
    runs: dict = {}
    with torch.no_grad():
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            enc, state_lengths = m.encoder(x, xl)
            ev[1].record()
            s = m.neural_hmm.sample(enc, state_lengths, budget, 0.0, c.duration_threshold,
                                    c.deterministic_transition)
            ev[2].record()
            mels = torch.nn.functional.pad(s["mels"], (0, 0, 0, -s["mels"].shape[1]
                                                       % c.num_squeeze))
            y_mask = sequence_mask(s["y_lengths"], mels.shape[1])[:, :, None].float()
            mels = m.decoder(mels, y_mask, reverse=True)[0] * c.mel_statistics_std \
                + c.mel_statistics_mean
            ev[3].record()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = int(s["y_lengths"][0])
            voc_in = synth.vocoder_ap.normalize(synth.ap.denormalize(
                mels[0, :frames].cpu().numpy().T))
            voc = torch.from_numpy(np.ascontiguousarray(voc_in.T[None], np.float32)).to(device)
            torch.cuda.synchronize()
            bridge = (time.perf_counter() - t0) * 1e3
            ev[4].record()
            synth.vocoder_model.inference(voc)
            ev[5].record()
            torch.cuda.synchronize()
            times = {"encoder": ev[0].elapsed_time(ev[1]),
                     "sampling loop": ev[1].elapsed_time(ev[2]),
                     "post-flow": ev[2].elapsed_time(ev[3]), "host bridge": bridge,
                     "HiFiGAN": ev[4].elapsed_time(ev[5])}
            for k, v in times.items():
                runs.setdefault(k, []).append(v)
    return {"times": {k: sorted(v)[reps // 2] for k, v in runs.items()}, "frames": frames}


def duration_margin(model, text: str, device) -> float:
    """Smallest distance of a token's unrounded duration from a .5 boundary
    in one AlignTTS or DelightfulTTS decode of ``text``, read from the
    duration predictor's output by a forward hook."""
    import torch

    x, xl = t2_ids(model, [text], device)
    acoustic = getattr(model.module, "acoustic_model", None)
    predictor = (acoustic or model.module).duration_predictor
    captured = {}
    handle = predictor.register_forward_hook(lambda mod, args, out: captured.update(log=out))
    try:
        with torch.no_grad():
            model.inference(x, xl, max_frames=64)
    finally:
        handle.remove()
    log = captured["log"].reshape(1, -1)[:, : int(xl[0])].float().cpu()
    raw = (torch.exp(log) - 1) * model.args.length_scale
    if acoustic is not None:  # DelightfulTTS rounds after its floor of one frame
        raw = torch.clamp(raw, min=1.0)
    raw = raw.numpy()
    return float(np.abs(raw - np.floor(raw) - 0.5).min())


def phase_hmm_align_delightful(card: str, device="cuda", cut=None) -> None:
    """Overflow and NeuralHMM with HiFiGAN, then AlignTTS and DelightfulTTS,
    at the LJSpeech recipes' widths, fp32 weights from seed 0: Overflow's
    transition bias calibrated on the card, the model saved in the reference
    layout with stand-in mel statistics and loaded back; the three phase 6
    sentences card against CPU (``y_lengths`` equal, mel within 1e-4 with
    its drift per 100 frames, the waveform on the short and medium ones);
    B = 4 rows against their own B = 1 decodes; a decode whose transition
    never fires, cut at its budget; ms and kernels per frame, latency, RTF
    and stages at natural length; both zoo names with ``hifigan_v2``;
    ``tts --vocoder_path``; the server, serial. NeuralHMM card against CPU
    on the short and medium sentences. AlignTTS (mel) and DelightfulTTS (mel
    and its own waveform, F28) card against CPU, their latency and one
    ``TTS.tts_to_file`` each. ``decode_attention`` must not launch. ``cut``
    shrinks the five configs in place, for rehearsals on the CPU."""
    import io
    import shutil

    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.align_tts import AlignTTS
    from tts_tpu_torch.models.delightful_tts import DelightfulTTS
    from tts_tpu_torch.models.overflow import NeuralhmmTTS, Overflow
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.utils.convert import reference_overflow_state
    from tts_tpu_torch.utils.synthesis import _frame_budget, synthesis
    from tts_tpu_torch.utils.synthesizer import SENTENCE_GAP, Synthesizer, split_into_sentences

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    cut = cut or (lambda *configs: None)
    decode_attention.launches = 0  # K1 is not on these paths: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    short, medium = VITS_SENTENCES["short"], VITS_SENTENCES["medium"]

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    def params(model) -> float:
        return sum(p.numel() for p in model.module.parameters()) / 1e6

    configs = (overflow_recipe_config(), neuralhmm_recipe_config(), align_tts_recipe_config(),
               delightful_tts_recipe_config(), hifigan_recipe_config())
    cut(*configs)
    ov_config, nh_config, al_config, dt_config, voc_config = configs
    with tempfile.TemporaryDirectory() as d:
        dirs = {k: os.path.join(d, k) for k in ("ov", "nh", "al", "dt", "voc")}
        for path in dirs.values():
            os.makedirs(path)

        # Overflow and NeuralHMM: the transition calibrated on the card, the
        # reference layout with stand-in mel statistics
        calibrated = {}
        for key, cls, config in (("ov", Overflow, ov_config), ("nh", NeuralhmmTTS, nh_config)):
            hmm = cls.init_from_config(config).init_params(seed=0, device=device)
            calibrated[key] = calibrate_transition(hmm, medium, device) + (params(hmm),)
            state = {k: v.cpu() for k, v in hmm.module.state_dict().items()}
            torch.save({"model": {k: torch.from_numpy(v) for k, v in reference_overflow_state(
                state, *HMM_MEL_STATS).items()}}, os.path.join(dirs[key], "model_file.pth"))
            write_json(os.path.join(dirs[key], "config.json"), hmm.config.to_dict())
            del hmm, state
        gen = random_vocoder(voc_config, seed=0)
        n_voc = sum(p.numel() for p in gen.parameters()) / 1e6
        torch.save({"model": {"model_g." + k: v for k, v in gen.state_dict().items()}},
                   os.path.join(dirs["voc"], "model_file.pth"))
        write_json(os.path.join(dirs["voc"], "config.json"), voc_config.to_dict())
        del gen
        args = {k: ["--model_path", os.path.join(dirs[k], "model_file.pth"), "--config_path",
                    os.path.join(dirs[k], "config.json")] for k in ("ov", "nh", "voc")}
        voc_args = ["--vocoder_path", args["voc"][1], "--vocoder_config_path", args["voc"][3]]

        def load(key, dev):
            return Synthesizer(tts_checkpoint=args[key][1], tts_config_path=args[key][3],
                               vocoder_checkpoint=voc_args[1], vocoder_config=voc_args[3],
                               device=dev)

        synth, cpu_synth = load("ov", device), load("ov", "cpu")
        model, c = synth.tts_model, synth.tts_model.config
        if (c.norm_type, c.mel_statistics_mean, c.mel_statistics_std) != \
                ("folded", *HMM_MEL_STATS):
            raise AssertionError(f"Overflow from the reference layout: norm {c.norm_type}, "
                                 f"statistics {c.mel_statistics_mean}, {c.mel_statistics_std}")
        (bias, pace, margin), grid, n_ov = calibrated["ov"]
        gp = voc_config.generator_model_params
        log(f"Overflow (LJSpeech recipe, phonemes from {model.tokenizer.phonemizer.name()}, "
            f"{c.text_cleaner}, num_chars {c.num_chars}): encoder {c.encoder_in_out_features} "
            f"({c.encoder_n_convolutions} convs, biLSTM) of {c.state_per_phone} states a token, "
            f"prenet {c.prenet_n_layers} x {c.prenet_dim}, memory LSTM {c.memory_rnn_dim}, output "
            f"net {c.outputnet_size}, post-flow {c.num_flow_blocks_dec} blocks of "
            f"{c.num_block_layers} WaveNet layers {c.hidden_channels_dec} wide; {n_ov:.2f} M "
            f"parameters (seed 0), loaded from the reference layout (folded norms, mel statistics "
            f"{HMM_MEL_STATS} from its mean/std). HiFiGAN: {gp['upsample_initial_channel']} "
            f"channels, upsampling {gp['upsample_factors']}, {voc_config.audio.sample_rate} Hz; "
            f"{n_voc:.2f} M parameters (seed 0)")
        log("Overflow transition bias (the output net projection's last row) on the medium "
            "sentence at its budget, frames a state / ended / smallest |p_move - threshold|: "
            + "; ".join(f"{b:+.1f}: {p:.2f} {'ended' if e else 'cut'} {m:.2g}"
                        for b, p, e, m in grid)
            + f" -> kept {bias:+.1f} ({pace:.2f} frames a state; random weights make the "
              f"stay/move rule bistable: a state's move probability settles, so it lasts a few "
              f"frames or never ends)")

        # card against CPU on the three sentences at their budgets
        worst_mel = worst_wav = 0.0
        lengths, drifts, margins = [], {}, []
        with torch.no_grad():
            for key, text in VITS_SENTENCES.items():
                g, w = synthesis(model, text), synthesis(cpu_synth.tts_model, text)
                g_len, w_len = g["outputs"]["y_lengths"].cpu(), w["outputs"]["y_lengths"]
                if not torch.equal(g_len, w_len) or g["model_outputs"].shape != \
                        w["model_outputs"].shape:
                    raise AssertionError(f"Overflow y_lengths card {g_len.tolist()} != CPU "
                                         f"{w_len.tolist()} for {key!r}")
                drifts[key] = drift_per_steps(g["model_outputs"], w["model_outputs"], 1)
                err = max(drifts[key])
                if not err <= HMM_TOL or not np.isfinite(g["model_outputs"]).all():
                    raise AssertionError(f"Overflow mel card vs CPU ({key}): max abs diff {err}; "
                                         f"per 100 frames {drifts[key]}")
                margins.append(decision_margin(g["outputs"], c.duration_threshold))
                if key in HMM_WAVE_KEYS:
                    gw, ww = synth._vocode(g["model_outputs"]), cpu_synth._vocode(
                        w["model_outputs"])
                    werr = float(np.abs(gw - ww).max()) if gw.shape == ww.shape else np.inf
                    if not werr <= HMM_TOL or not np.isfinite(gw).all() or gw.std() == 0:
                        raise AssertionError(f"Overflow + HiFiGAN card vs CPU ({key}): "
                                             f"{gw.shape} vs {ww.shape}, max abs diff {werr}")
                    worst_wav = max(worst_wav, werr)
                worst_mel = max(worst_mel, err)
                lengths.append(int(g_len[0]))
        log(f"Overflow + HiFiGAN card vs CPU, the three phase 6 sentences: y_lengths {lengths} "
            f"equal, mel max abs diff {worst_mel:.3g}, waveform ({', '.join(HMM_WAVE_KEYS)}) "
            f"{worst_wav:.3g} (tol {HMM_TOL}); smallest |p_move - threshold| per sentence "
            + ", ".join(f"{m:.2g}" for m in margins) + "; mel max abs diff per 100 frames: "
            + "; ".join(f"{k} " + ", ".join(f"{v:.2g}" for v in vs) for k, vs in drifts.items())
            + f" (phase 13 at {time.time() - t_phase:.0f} s)")
        cpu_model = cpu_synth.tts_model
        del cpu_synth

        # B = 4 rows against their own B = 1 decodes
        rows = list(VITS_SENTENCES.values()) + [MULTI_SENTENCES["en"]]
        with torch.no_grad():
            x, xl = t2_ids(model, rows, device)
            budget = _frame_budget(int(xl.max()))
            batch = model.inference(x, xl, max_frames=budget)
            b4err = 0.0
            for i, text in enumerate(rows):
                xi, xli = t2_ids(model, [text], device)
                one = model.inference(xi, xli, max_frames=budget)
                n = int(one["y_lengths"][0])
                if n != int(batch["y_lengths"][i]):
                    raise AssertionError(f"B=4 row {i}: y_lengths {batch['y_lengths'][i]} vs "
                                         f"{n} alone")
                b4err = max(b4err, float((batch["model_outputs"][i, :n]
                                          - one["model_outputs"][0, :n]).abs().max()))
        if not b4err <= HMM_TOL:
            raise AssertionError(f"Overflow B=4 rows vs their B=1 decodes: max abs diff {b4err}")
        log(f"Overflow B=4 ({[int(v) for v in xl]} tokens padded to {x.shape[1]}), each row "
            f"against its own B=1 decode at a {budget}-frame budget: y_lengths "
            f"{batch['y_lengths'].tolist()} equal, mel max abs diff {b4err:.3g} (tol {HMM_TOL})")

        # a transition that never fires: cut at the budget, not sooner
        set_transition(model, HMM_NEVER)
        set_transition(cpu_model, HMM_NEVER)
        with torch.no_grad():
            xm, xlm = t2_ids(model, [medium], device)
            budget = _frame_budget(int(xlm[0]))
            out = model.inference(xm, xlm, max_frames=budget)
            cpu_out = cpu_model.inference(xm.cpu(), xlm.cpu(), max_frames=budget)
        ran = out["transitions"].shape[1]
        nerr = float((out["model_outputs"].cpu() - cpu_out["model_outputs"]).abs().max())
        if int(out["y_lengths"][0]) != budget or ran != budget or not nerr <= HMM_TOL:
            raise AssertionError(f"never-firing transition: y_lengths {out['y_lengths'].tolist()}, "
                                 f"{ran} of {budget} steps run, card vs CPU {nerr}")
        log(f"Overflow transition never firing (bias {HMM_NEVER}): the medium sentence cut at its "
            f"{budget}-frame budget, all {ran} steps run; card vs CPU mel max abs diff "
            f"{nerr:.3g} (tol {HMM_TOL})")
        del cpu_model

        # speed: ms and kernels per frame on the never-firing decode
        if cuda:
            per_frame = {}
            for texts in ([medium], rows):
                xb, xlb = t2_ids(model, texts, device)

                def decode(n, xb=xb, xlb=xlb):
                    return model.inference(xb, xlb, max_frames=n)

                ms = step_ms(decode, device, *HMM_TIMING)
                k, dev_ms = kernels_per_step(
                    decode, f"Overflow B={len(texts)} decode of {{}} frames (never moving)", card,
                    *HMM_PROFILE)
                per_frame[len(texts)] = (ms, k, dev_ms)
            log(f"Overflow frame (wall: slope between {HMM_TIMING[0]} and {HMM_TIMING[1]} frames, "
                f"median of 3; kernels and device time: profiled {HMM_PROFILE[1]} less "
                f"{HMM_PROFILE[0]} frames): " + "; ".join(
                    f"B={b} {ms:.3f} ms wall, {k:.1f} kernels, {dev * 1e3:.1f} us device"
                    for b, (ms, k, dev) in per_frame.items()) + f" | {card}")
        paced = {}

        def at_pace():
            t0 = time.perf_counter()
            with torch.no_grad():
                o = model.inference(xm, xlm, max_frames=int(HMM_PACE * 2 * int(xlm[0])))
                mel = o["model_outputs"][0, : int(o["y_lengths"][0])].cpu().numpy()
            paced.update(frames=len(mel), model=(time.perf_counter() - t0) * 1e3,
                         seconds=len(synth._vocode(mel)) / synth.output_sample_rate)

        ms, lo, hi = median_ms(at_pace, device, reps=3)
        log(f"Overflow + HiFiGAN medium sentence at LJSpeech's pace ({HMM_PACE:.0f} frames a "
            f"state: {paced['frames']} frames of a decode that never moves, cut there): "
            f"{paced['seconds']:.2f} s of audio in {ms:.1f} ms (median of 3; {lo:.1f}-{hi:.1f}), "
            f"RTF {paced['seconds'] / ms * 1e3:.1f}, the decode {paced['model']:.1f} ms | {card}")
        set_transition(model, bias)

        # latency and RTF at natural length, the medium sentence's stages
        sr = synth.output_sample_rate
        for key, text in VITS_SENTENCES.items():
            parts = {}

            def natural(text=text, parts=parts):
                t0 = time.perf_counter()
                with torch.no_grad():
                    mel = synthesis(model, text)["model_outputs"]
                t1 = time.perf_counter()
                wav = synth._vocode(mel)
                sync(device)
                parts.update(frames=len(mel), model=(t1 - t0) * 1e3,
                             vocoder=(time.perf_counter() - t1) * 1e3, seconds=len(wav) / sr)

            ms, lo, hi = median_ms(natural, device, reps=3)
            log(f"Overflow + HiFiGAN {key}: natural length ({parts['frames']} frames) "
                f"{parts['seconds']:.2f} s of audio in {ms:.1f} ms (median of 3; {lo:.1f}-"
                f"{hi:.1f}), RTF {parts['seconds'] / ms * 1e3:.1f}, HiFiGAN with the bridge "
                f"{parts['vocoder']:.1f} ms | {card}")
        if cuda:
            profile_call(lambda: synth._vocode(synthesis(model, medium)["model_outputs"]),
                         "Overflow + HiFiGAN, medium sentence at natural length", card)
            st = hmm_stage_ms(synth, medium, device)
            log(f"Overflow + HiFiGAN stages, medium sentence at natural length ({st['frames']} "
                f"frames), ms (median of 5; the bridge by the host clock, the rest by CUDA "
                f"events): " + ", ".join(f"{k} {v:.2f}" for k, v in st["times"].items())
                + f" | {card}")

        # NeuralHMM: card against CPU
        nh, nh_cpu = load("nh", device), load("nh", "cpu")
        with torch.no_grad():
            for key in ("short", "medium"):
                g = synthesis(nh.tts_model, VITS_SENTENCES[key])
                w = synthesis(nh_cpu.tts_model, VITS_SENTENCES[key])
                same = torch.equal(g["outputs"]["y_lengths"].cpu(), w["outputs"]["y_lengths"])
                err = float(np.abs(g["model_outputs"] - w["model_outputs"]).max()) if same \
                    else np.inf
                if not err <= HMM_TOL or not np.isfinite(g["model_outputs"]).all():
                    raise AssertionError(f"NeuralHMM card vs CPU ({key}): y_lengths "
                                         f"{g['outputs']['y_lengths'].tolist()} vs "
                                         f"{w['outputs']['y_lengths'].tolist()}, {err}")
                log(f"NeuralHMM (LJSpeech recipe, {calibrated['nh'][2]:.2f} M parameters, "
                    f"transition bias {calibrated['nh'][0][0]:+.1f}: "
                    f"{calibrated['nh'][0][1]:.2f} frames a state) {key} card vs CPU: y_lengths "
                    f"{int(g['outputs']['y_lengths'][0])} equal, mel max abs diff {err:.3g}, "
                    f"smallest |p_move - threshold| "
                    f"{decision_margin(g['outputs'], nh.tts_model.config.duration_threshold):.2g}")
        del nh, nh_cpu

        # the zoo by name: reference-layout directories, nothing fetched
        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            shutil.copytree(dirs["voc"], os.path.join(home, "tts_tpu",
                                                      ZOO_HIFIGAN_V2.replace("/", "--")))
            for key, name in (("ov", ZOO_OVERFLOW), ("nh", ZOO_NEURAL_HMM)):
                shutil.copytree(dirs[key], os.path.join(home, "tts_tpu", name.replace("/", "--")))
                by_name = TTS(model_name=name, device=device)
                by_path = TTS(model_path=args[key][1], config_path=args[key][3],
                              vocoder_path=voc_args[1], vocoder_config_path=voc_args[3],
                              device=device)
                a = np.asarray(silent(by_name.tts, short), np.float32)
                b = np.asarray(silent(by_path.tts, short), np.float32)
                zerr = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
                if zerr != 0 or a.std() == 0:
                    raise AssertionError(f"TTS(model_name={name}) vs path load: {a.shape} vs "
                                         f"{b.shape}, max abs diff {zerr}")
                log(f"zoo: {name} with its default vocoder {ZOO_HIFIGAN_V2} from reference-layout "
                    f"directories, nothing fetched; the short sentence differs from the path "
                    f"load by {zerr}")
                del by_name, by_path

        # the command line with the vocoder flags against the API, the server
        api = TTS(model_path=args["ov"][1], config_path=args["ov"][3], vocoder_path=voc_args[1],
                  vocoder_config_path=voc_args[3], device=device)
        api_path, cli_path = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
        silent(api.tts_to_file, short, file_path=api_path)
        silent(synthesize_cli, ["--text", short, "--out_path", cli_path, "--device",
                                str(device)] + args["ov"] + voc_args)
        step, cli_sr = _int16_steps(cli_path, api_path)
        if step is None or step > 1:
            raise AssertionError(f"tts --vocoder_path (Overflow) vs the API: {step} int16 steps")
        log(f"tts --model_path --config_path --vocoder_path --vocoder_config_path (Overflow): at "
            f"{cli_sr} Hz, at most {step} int16 step from TTS.tts_to_file")
        del api
        status, body, said, dispatched = _serve_once(args["ov"] + voc_args, {"text": short},
                                                     device)
        if status != 200 or "serving serially" not in said or dispatched:
            raise AssertionError(f"Overflow server with --max_batch 4: {status}, {said!r}")
        line = [ln for ln in said.splitlines() if "serially" in ln][0].strip()
        log(f"Overflow server (--vocoder_path, --max_batch 4): said {line!r}; /api/tts answered "
            f"{len(body)} bytes")
        del synth, model

        # AlignTTS (with HiFiGAN) and DelightfulTTS (its joint vocoder, F28)
        for key, cls, config in (("al", AlignTTS, al_config), ("dt", DelightfulTTS, dt_config)):
            m = cls.init_from_config(config).init_params(seed=0, device="cpu")
            torch.save(m.module.state_dict(), os.path.join(dirs[key], "model_torch.pt"))
            write_json(os.path.join(dirs[key], "config.json"), m.config.to_dict())
            n_m = params(m)
            del m
            path = [os.path.join(dirs[key], "model_torch.pt"), os.path.join(dirs[key],
                                                                            "config.json")]
            vocoder = {"vocoder_checkpoint": voc_args[1], "vocoder_config": voc_args[3]} \
                if key == "al" else {}
            g_synth = Synthesizer(tts_checkpoint=path[0], tts_config_path=path[1], device=device,
                                  **vocoder)
            w_synth = Synthesizer(tts_checkpoint=path[0], tts_config_path=path[1], device="cpu",
                                  **vocoder)
            g_model = g_synth.tts_model
            name = "AlignTTS" if key == "al" else "DelightfulTTS"
            for sentence in (("short", "medium") if key == "al" else ("short",)):
                text = VITS_SENTENCES[sentence]
                with torch.no_grad():
                    g, w = synthesis(g_model, text), synthesis(w_synth.tts_model, text)
                n = int(g["outputs"]["y_lengths"][0])
                if n != int(w["outputs"]["y_lengths"][0]):
                    raise AssertionError(f"{name} y_lengths card {n} vs CPU "
                                         f"{w['outputs']['y_lengths'].tolist()} ({sentence})")
                if key == "al":
                    g_mel, w_mel = g["model_outputs"], w["model_outputs"]
                    errs = {"mel": float(np.abs(g_mel - w_mel).max())}
                else:
                    g_mel = g["outputs"]["mel"][0, :n].cpu().numpy()
                    w_mel = w["outputs"]["mel"][0, :n].numpy()
                    errs = {"mel": float(np.abs(g_mel - w_mel).max()),
                            "waveform": float(np.abs(g["wav"] - w["wav"]).max())}
                    if g["wav"].shape != (n * g_model.hop_length,) or g["wav"].std() == 0:
                        raise AssertionError(f"DelightfulTTS waveform {g['wav'].shape} for {n} "
                                             f"frames")
                if not max(errs.values()) <= HMM_TOL:
                    raise AssertionError(f"{name} card vs CPU ({sentence}): {errs}")
                log(f"{name} (LJSpeech recipe, {n_m:.2f} M parameters, seed 0) {sentence} card "
                    f"vs CPU: y_lengths {n} equal, "
                    + ", ".join(f"{k} max abs diff {v:.3g}" for k, v in errs.items())
                    + f" (tol {HMM_TOL}; the mel's peak {float(np.abs(w_mel).max()):.3g}); "
                      f"smallest distance of a duration from a .5 boundary "
                      f"{duration_margin(g_model, text, device):.3g}")
            del w_synth
            samples = []
            ms, lo, hi = median_ms(lambda: samples.append(len(silent(g_synth.tts, medium))),
                                   device, reps=3)
            audio = (samples[-1] - SENTENCE_GAP * len(split_into_sentences(medium))) / \
                g_synth.output_sample_rate
            if cuda and key == "dt":
                profile_call(lambda: silent(g_synth.tts, medium),
                             "DelightfulTTS, medium sentence through Synthesizer.tts", card)
            api = TTS(model_path=path[0], config_path=path[1], device=device,
                      **({"vocoder_path": voc_args[1], "vocoder_config_path": voc_args[3]}
                         if key == "al" else {}))
            wav_path = os.path.join(d, f"{key}.wav")
            silent(api.tts_to_file, short, file_path=wav_path)
            log(f"{name}{' + HiFiGAN' if key == 'al' else ' (joint vocoder)'} medium sentence "
                f"through Synthesizer.tts: {audio:.2f} s of audio in {ms:.1f} ms (median of 3; "
                f"{lo:.1f}-{hi:.1f}), RTF {audio / ms * 1e3:.1f}; TTS.tts_to_file wrote "
                f"{os.path.getsize(wav_path)} bytes | {card}")
            del g_synth, g_model, api

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during phase 13")
    line = ("Overflow, NeuralHMM, AlignTTS, DelightfulTTS: no hand-written kernel on these paths "
            "(decode_attention launches 0)")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 13 took {time.time() - t_phase:.1f} s | {card}")


ZOO_PAIRINGS = {  # the Tacotron2 entries whose default vocoders phase 14 brings
    "tts_models/en/ek1/tacotron2": ("vocoder_models/en/ek1/wavegrad", "wavegrad"),
    "tts_models/en/ljspeech/tacotron2-DDC_ph": ("vocoder_models/en/ljspeech/univnet", "univnet"),
    "tts_models/nl/mai/tacotron2-DDC": ("vocoder_models/nl/mai/parallel-wavegan",
                                        "parallel_wavegan"),
}
VOCODER_TOL = 1e-4  # card vs CPU, the vocoders of phase 14, fp32 with TF32 off
VOCODER_CHECK_FRAMES = 64  # the mel of the card-against-CPU checks
WAVERNN_CHECK_FRAMES = 10  # WaveRNN's: (10 - 4) x 256 = 1536 samples a side
WAVERNN_TIMING_FRAMES = 16  # the clip WaveRNN's us per sample is timed on
WAVERNN_PROFILE_FRAMES = 6  # the clip its kernels per sample are counted on
T2_STOP_BIAS = 10.0  # the stopnet fires at step 1: one step of r = 6 frames for the surfaces


def vocoder_recipe_configs() -> dict:
    """The five vocoders at full width, 22.05 kHz, hop 256, 80 mels:
    ``ParallelWaveganConfig`` (30 layers in 3 stacks, 64 residual, 128 gate
    and 64 skip channels, upsampling [4, 4, 4, 4]), ``UnivnetConfig`` (the
    generator's defaults: 64 noise channels, 32 hidden, LVC blocks [8, 8, 4]
    of 4 layers, a 64-wide kernel predictor), ``WavegradConfig`` (768 wide,
    upsampling [4, 4, 4, 2, 2], 50 test steps), ``WavernnConfig`` (``mold``,
    512-wide GRUs and dense layers, 10 resnet blocks, upsampling [4, 8, 8])
    and the MB-iSTFT-VITS decoder's widths (``mb_istft_config``) as a
    stand-alone iSTFT generator on the mel."""
    from tts_tpu_torch.vocoder import configs

    istft = configs.GANConfig(generator_model="istft_hifigan_generator", generator_model_params={
        "upsample_initial_channel": 512, "upsample_factors": [4, 4],
        "upsample_kernel_sizes": [16, 16], "istft_n_fft": 16, "istft_hop": 4, "subbands": 4})
    return {"parallel_wavegan": configs.ParallelWaveganConfig(),
            "univnet": configs.UnivnetConfig(), "wavegrad": configs.WavegradConfig(),
            "wavernn": configs.WavernnConfig(), "istft_hifigan": istft}


def vocoder_fidelity(device) -> str:
    """``parallel_wavegan.npz``, ``univnet.npz``, ``wavegrad.npz`` and
    ``wavernn.npz`` (reference-layout state dicts with the reference code's
    outputs) through the port's converters on ``device``, at
    ``test_fidelity_corpus``'s thresholds: the log-mel distance of the
    waveforms on the fixtures' own noise, WaveRNN's teacher-forced logits'
    RMSE."""
    import torch

    from tts_tpu_torch.utils.convert import load_reference_vocoder
    from tts_tpu_torch.vocoder import configs
    from tts_tpu_torch.vocoder.utils import make_generator_from_config

    widths = {
        "parallel_wavegan": ("ParallelWaveganConfig", "generator_model_params", dict(
            num_res_blocks=6, stacks=3, res_channels=8, gate_channels=16, skip_channels=8,
            upsample_factors=[4, 4])),
        "univnet": ("UnivnetConfig", "generator_model_params", dict(
            in_channels=8, hidden_channels=8, upsample_factors=[2, 2], lvc_layers_each_block=2,
            kpnet_hidden_channels=8)),
        "wavegrad": ("WavegradConfig", "model_params", dict(
            y_conv_channels=8, x_conv_channels=24, dblock_out_channels=[8, 12],
            ublock_out_channels=[24, 12, 8], upsample_factors=[2, 2, 2],
            upsample_dilations=[[1, 2, 1, 2]] * 3)),
        "wavernn": ("WavernnConfig", "model_args", dict(
            rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8, num_res_blocks=2,
            upsample_factors=[2, 2])),
    }
    said = []
    for family, (kind, field, params) in widths.items():
        npz = np.load(os.path.join(REPO, "tests", "fixtures", "fidelity", f"{family}.npz"))
        part = {p: {k[len(p) + 1:]: npz[k] for k in npz.files if k.startswith(p + "/")}
                for p in ("sd", "in", "out")}
        ins, outs = part["in"], part["out"]
        config = getattr(configs, kind)()
        config.audio.num_mels = ins["mel"].shape[1]
        setattr(config, field, params)
        gen = make_generator_from_config(config)
        gen.load_state_dict(load_reference_vocoder(part["sd"], config), strict=True)
        gen = gen.to(device).eval()
        mel = torch.from_numpy(ins["mel"].transpose(0, 2, 1)).to(device)
        with torch.no_grad():
            if family == "wavernn":
                logits = gen(torch.from_numpy(ins["x"]).to(device), mel).cpu().numpy()[0]
                rmse = float(np.sqrt(np.mean((logits - outs["logits"][0]) ** 2)))
                if not rmse < FIDELITY_RMSE:
                    raise AssertionError(f"wavernn.npz on {device}: logits RMSE {rmse}")
                said.append(f"wavernn.npz logits RMSE {rmse:.3g} (< {FIDELITY_RMSE})")
                continue
            if family == "wavegrad":
                wav = gen(torch.from_numpy(ins["x"].transpose(0, 2, 1)).to(device), mel,
                          torch.from_numpy(ins["noise_scale"]).to(device))
            else:
                wav = gen(mel, torch.from_numpy(ins["noise"].transpose(0, 2, 1)).to(device))
        wav = wav.cpu().numpy()[0, :, 0]
        ref = outs["wav"][0, 0]
        lsd = _lsd_db(ref, wav) if len(wav) == len(ref) else np.inf
        if not lsd < FIDELITY_LSD_DB:
            raise AssertionError(f"{family}.npz on {device}: {len(wav)} samples, LSD {lsd}")
        said.append(f"{family}.npz LSD {lsd:.3g} dB (max abs diff "
                    f"{float(np.abs(ref - wav).max()):.3g})")
    return "; ".join(said) + f" (< {FIDELITY_LSD_DB} dB)"


WAVEGRAD_FILM_SCALE = 0.1  # random FiLM weights at 1 / fan-in make the reverse diffusion diverge


def calibrate_wavegrad(gen, frames: int = 16, seed: int = 6) -> float:
    """Tame random WaveGrad weights for a 50-step reverse diffusion: the
    FiLM output convs scaled by ``WAVEGRAD_FILM_SCALE`` (at 1 / fan-in the
    shift and scale they give grow with ``y``, and the loop diverges to inf
    within 30 steps in CPU rehearsals at small widths; a trained model's
    prediction tracks the noise in ``y`` instead), then the head
    (``out_conv``, which the JAX package initialises at zero) scaled so that
    the predicted noise has a standard deviation of 1 on pure noise at the
    first reverse step. Returns the head's factor."""
    import torch

    from tts_tpu_torch.vocoder.models.wavegrad import compute_noise_schedule

    rs = np.random.RandomState(seed)
    mel = torch.from_numpy(rs.randn(1, frames, gen.x_conv.in_channels).astype(np.float32))
    y = torch.from_numpy(rs.randn(1, frames * gen.hop, 1).astype(np.float32))
    nl = torch.full((1,), float(np.sqrt(compute_noise_schedule(50)[2][-1])))
    with torch.no_grad():
        for name, module in gen.named_modules():
            if name.endswith("output_conv"):
                module.weight.mul_(WAVEGRAD_FILM_SCALE)
        factor = 1.0 / float(gen(y, mel, nl).std())
        gen.out_conv.weight.mul_(factor)
    return factor


def calibrate_univnet(gen) -> float:
    """Scale each LVC block's kernel predictor's ``kernel_conv`` by ``1 /
    sqrt(C_in K)``, so that the kernels it predicts from random weights sit
    at 1 / fan-in, as a convolution's random weights do (unscaled, each LVC
    layer multiplies its input by ~10, and the gates saturate). Returns the
    factor."""
    import torch

    block = gen.lvc_0
    factor = 1.0 / float(np.sqrt(block.in_channels * block.kernel_predictor.shape[3]))
    with torch.no_grad():
        for n in range(len(gen.upsample_factors)):
            getattr(gen, f"lvc_{n}").kernel_predictor.kernel_conv.weight.mul_(factor)
    return factor


def gumbel_margin(logits, gumbel) -> "torch.Tensor":
    """Per step, the gap between the best and the second-best mixture
    component of WaveRNN's Gumbel-max choice: ``logits`` ``[1, T, 30]``,
    ``gumbel`` ``[T, 1, 10]`` → ``[T]``."""
    import torch

    nr_mix = logits.shape[-1] // 3
    top = torch.topk(logits[0, :, :nr_mix] + gumbel[:, 0].to(logits), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def wavernn_against_cpu(gen, cpu_gen, device) -> str:
    """WaveRNN card against CPU on a ``WAVERNN_CHECK_FRAMES``-frame mel:
    ``generate`` on draws made once on the CPU, then the teacher-forced
    logits of both sides along the card's samples (the steps ``generate``
    ran, on the card). A sample that differs by more than the tolerance is
    traced to its step: where the mixture component flipped there, the step
    and its Gumbel margin are printed, and the phase fails."""
    import torch

    mel = torch.from_numpy(np.random.RandomState(3).randn(1, WAVERNN_CHECK_FRAMES, 80).astype(
        np.float32))
    T = (WAVERNN_CHECK_FRAMES - 4) * gen.hop
    noise = cpu_gen.draw_noise(T, 1, torch.Generator().manual_seed(2))
    card = gen.generate(mel.to(device), noise={k: v.to(device) for k, v in noise.items()}).cpu()
    host = cpu_gen.generate(mel, noise=noise)
    prev = torch.cat([card.new_zeros(1, 1), card[:, :-1]], 1)
    with torch.no_grad():
        got = gen(prev.to(device), mel.to(device)).cpu()
        want = cpu_gen(prev, mel)
    margins = gumbel_margin(got, noise["gumbel"])
    nr = got.shape[-1] // 3
    comps = [torch.argmax(v[0, :, :nr] + noise["gumbel"][:, 0], -1) for v in (got, want)]
    err, lerr = float((card - host).abs().max()), float((got - want).abs().max())
    if not err <= VOCODER_TOL:
        t = int(((card - host).abs() > VOCODER_TOL).nonzero()[0, 1])
        flipped = bool(comps[0][t] != comps[1][t])
        raise AssertionError(f"WaveRNN generate card vs CPU: max abs diff {err}, first at sample "
                             f"{t}; mixture component {'flipped' if flipped else 'kept'} there, "
                             f"Gumbel margin {float(margins[t]):.3g}")
    if not lerr <= VOCODER_TOL:
        raise AssertionError(f"WaveRNN teacher-forced logits card vs CPU: max abs diff {lerr}")
    return (f"generate ({T} samples on CPU-drawn noise) max abs diff {err:.3g}, no mixture "
            f"component flipped (smallest Gumbel margin {float(margins.min()):.3g} at sample "
            f"{int(margins.argmin())}); the teacher-forced logits along those samples max abs "
            f"diff {lerr:.3g}")


def kernels_and_device_us(fn) -> tuple:
    """``(kernels, device microseconds)`` of one call of ``fn`` under
    ``torch.profiler`` (kernel rows only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after one warm-up."""
    import torch

    fn()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return sorted(runs)[reps // 2]


def vocoder_timings(gens: dict, schedule, frames: int, sr: int, device, card: str) -> None:
    """Each vocoder alone at B = 1 on a seeded mel of ``frames`` frames (the
    medium sentence at the Tacotron2 phase's natural length): latency, RTF,
    operations (``torch``'s counter), kernels and busy share under
    ``torch.profiler``, working memory; WaveGrad's two branches of one step
    by CUDA events; WaveRNN's us a sample on a ``WAVERNN_TIMING_FRAMES``
    clip and its kernels a sample on a ``WAVERNN_PROFILE_FRAMES`` one."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tts_tpu_torch.vocoder.models.wavegrad import wavegrad_inference

    wg = gens["wavegrad"]
    steps = len(schedule[0])
    mel_m = torch.from_numpy(np.random.RandomState(4).randn(1, frames, 80).astype(
        np.float32)).to(device)
    calls = {
        "parallel_wavegan": lambda: gens["parallel_wavegan"].inference(mel_m),
        "univnet": lambda: gens["univnet"].inference(mel_m),
        "istft_hifigan": lambda: gens["istft_hifigan"].inference(mel_m),
        "wavegrad": lambda: wavegrad_inference(wg, mel_m, schedule),
    }
    for k, fn in calls.items():
        with torch.no_grad():
            with FlopCounterMode(display=False) as counter:
                out = fn()
            audio = out.shape[1] / sr
            del out
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms, lo, hi = median_ms(fn, device, reps=3)
            peak = torch.cuda.max_memory_allocated() - base
            n_k, dev_us = kernels_and_device_us(fn)
        gflop = counter.get_total_flops() / 1e9
        log(f"{k} on the medium sentence's mel ({frames} frames, the Tacotron2 phase's natural "
            f"length; {audio:.2f} s of audio): {ms:.1f} ms (median of 3; {lo:.1f}-{hi:.1f}), "
            f"RTF {audio / ms * 1e3:.1f}; {gflop:.1f} GFLOP (torch's counter: convolutions "
            f"and matmuls), {gflop / ms:.1f} TFLOP/s; {n_k} kernels, device busy "
            f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e3 / ms:.1f} % of the median wall); "
            f"peak {peak / 1e9:.3f} GB above the weights and the mel | {card}")
    nl = torch.full((1,), float(np.sqrt(schedule[2][steps // 2])), device=device)
    y = torch.randn((1, frames * wg.hop, 1), device=device)
    with torch.no_grad():
        ss = wg.film(y, nl)
        film_ms = cuda_ms(lambda: wg.film(y, nl))
        decode_ms = cuda_ms(lambda: wg.decode(mel_m, ss))
    log(f"WaveGrad step on {frames} frames (CUDA events, median of 5): waveform branch "
        f"(y_conv, 4 DBlocks, 5 FiLMs) {film_ms:.2f} ms, mel branch (x_conv, 5 UBlocks, "
        f"out_conv) {decode_ms:.2f} ms; {steps} steps | {card}")
    wr = gens["wavernn"]
    for n_frames in (WAVERNN_PROFILE_FRAMES, WAVERNN_TIMING_FRAMES):
        clip = torch.from_numpy(np.random.RandomState(5).randn(1, n_frames, 80).astype(
            np.float32)).to(device)
        samples = (n_frames - 4) * wr.hop
        if n_frames == WAVERNN_TIMING_FRAMES:  # one run: the profiled clip below warms it
            ms = median_ms(lambda: wr.generate(clip), device, reps=1)[0]
            log(f"WaveRNN generate, {n_frames}-frame clip ({samples} samples): {ms:.1f} ms "
                f"(one run), {ms * 1e3 / samples:.1f} us a sample, RTF "
                f"{samples / sr / ms * 1e3:.3f} | {card}")
        else:
            wr.generate(clip)
            n_k, dev_us = kernels_and_device_us(lambda: wr.generate(clip))
            log(f"WaveRNN generate, {n_frames}-frame clip ({samples} samples) under "
                f"torch.profiler: {n_k / samples:.1f} kernels and {dev_us / samples:.1f} us of "
                f"device a sample | {card}")


def phase_vocoders(card: str, device="cuda", cut=None) -> None:
    """ParallelWaveGAN, UnivNet, WaveGrad, WaveRNN and the iSTFT generator
    at full width (``vocoder_recipe_configs``), fp32 weights from seed 0:
    card against CPU on one seeded mel with the noise drawn once on the CPU
    (WaveGrad's ``y`` before the clip after its 50 steps, with the largest
    difference per 10 steps and of the FiLM table; WaveRNN's logits and
    samples); the four fidelity fixtures on the card; each vocoder alone on
    the medium sentence's mel at the Tacotron2 phase's natural length
    (latency, RTF, busy share, kernels, peak memory; WaveGrad's ms per step
    and its two branches; WaveRNN's us and kernels per sample on short
    clips); the three Tacotron2 pairings by zoo name against the path load,
    ``tts --vocoder_path``, one WaveRNN ``TTS.tts_to_file`` and the server,
    serial. ``decode_attention`` must not launch. ``cut`` shrinks the six
    configs in place (the five vocoders' by name, then the Tacotron2's), for
    rehearsals on the CPU."""
    import io
    import shutil

    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.text.tokenizer import TTSTokenizer
    from tts_tpu_torch.utils import convert
    from tts_tpu_torch.vocoder.models.wavegrad import compute_noise_schedule, wavegrad_inference

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    decode_attention.launches = 0  # K1 is not on these paths: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    short, medium = VITS_SENTENCES["short"], VITS_SENTENCES["medium"]

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    configs, t2_config = vocoder_recipe_configs(), tacotron2_recipe_config()
    if cut:
        cut(configs, t2_config)
    cpu_gens = {k: random_vocoder(c, seed=0) for k, c in configs.items()}
    head = calibrate_wavegrad(cpu_gens["wavegrad"])
    lvc = calibrate_univnet(cpu_gens["univnet"])
    gens = {k: copy.deepcopy(g).to(device) for k, g in cpu_gens.items()}
    sizes = ", ".join(f"{k} {sum(p.numel() for p in g.parameters()) / 1e6:.2f} M"
                      for k, g in cpu_gens.items())
    log(f"vocoders at full width (seed 0, fp32): {sizes} parameters; WaveGrad's FiLM output "
        f"convs scaled by {WAVEGRAD_FILM_SCALE} and its head by {head:.3g}, so that its predicted "
        f"noise has a standard deviation of 1 on pure noise; UnivNet's kernel convs by "
        f"{lvc:.3g}, so that its predicted kernels sit at 1 / fan-in")

    # card against CPU: one seeded mel, the noise drawn once on the CPU
    rs = np.random.RandomState(0)
    mel = torch.from_numpy(rs.randn(1, VOCODER_CHECK_FRAMES, 80).astype(np.float32))
    draw = torch.Generator().manual_seed(1)
    errs = {}
    with torch.no_grad():
        for k in ("parallel_wavegan", "univnet", "istft_hifigan"):
            g, c = gens[k], cpu_gens[k]
            if k == "istft_hifigan":
                a, b = g.inference(mel.to(device)).cpu(), c.inference(mel)
            else:
                shape = ((1, (VOCODER_CHECK_FRAMES + 2 * c.inference_padding) * c.hop, 1)
                         if k == "parallel_wavegan" else (1, VOCODER_CHECK_FRAMES, c.in_channels))
                x = torch.randn(shape, generator=draw)
                a = g.inference(mel.to(device), x=x.to(device)).cpu()
                b = c.inference(mel, x=x)
            errs[k] = float((a - b).abs().max()) if a.shape == b.shape else np.inf
            if not errs[k] <= VOCODER_TOL or not torch.isfinite(a).all() or a.std() == 0:
                raise AssertionError(f"{k} card vs CPU: {tuple(a.shape)} vs {tuple(b.shape)}, "
                                     f"max abs diff {errs[k]}")
    log("card vs CPU on a seeded " + f"{VOCODER_CHECK_FRAMES}-frame mel, noise drawn once on the "
        "CPU: " + ", ".join(f"{k} max abs diff {v:.3g}" for k, v in errs.items())
        + f" (tol {VOCODER_TOL}) (phase 14 at {time.time() - t_phase:.0f} s)")

    tokenizer, _ = TTSTokenizer.init_from_config(t2_config)
    frames = 3 * len(tokenizer.text_to_ids(medium)) * T2_DECODE_R  # Tacotron2's natural length
    sched = configs["wavegrad"].test_noise_schedule
    schedule = compute_noise_schedule(sched["num_steps"], sched["min_val"], sched["max_val"])
    steps = len(schedule[0])
    wg, wg_cpu = gens["wavegrad"], cpu_gens["wavegrad"]
    T_wav = VOCODER_CHECK_FRAMES * wg.hop
    noise = torch.randn((steps + 1, 1, T_wav, 1), generator=draw)
    seen = {}

    def record(key):
        def hook(module, args):
            seen.setdefault(key, []).append(args[0].detach().cpu())
        return hook

    hooks = [wg.register_forward_pre_hook(record("card")),
             wg_cpu.register_forward_pre_hook(record("cpu"))]
    a = wavegrad_inference(wg, mel.to(device), schedule, noise=noise.to(device), clip=False).cpu()
    b = wavegrad_inference(wg_cpu, mel, schedule, noise=noise, clip=False)
    for h in hooks:
        h.remove()
    per_step = [float((p - q).abs().max()) for p, q in zip(seen["card"], seen["cpu"])] + [
        float((a - b).abs().max())]
    err = per_step[-1]
    if not err <= VOCODER_TOL or not torch.isfinite(a).all():
        raise AssertionError(f"WaveGrad y before the clip, card vs CPU after {steps} steps: {err}")
    film, T_big = wg.film_0, frames * wg.hop
    table = float((film.positional_table(T_big, device).cpu()
                   - wg_cpu.film_0.positional_table(T_big, "cpu")).abs().max())
    log(f"WaveGrad card vs CPU ({steps} steps, {T_wav} samples, the first y and each z drawn once "
        f"on the CPU): y before the clip max abs diff {err:.3g} (tol {VOCODER_TOL}; |y| up to "
        f"{float(b.abs().max()):.3g}, {float((b.abs() > 1).float().mean()) * 100:.1f} % of it "
        f"beyond the clip); largest difference after each 10 steps: "
        + ", ".join(f"{per_step[i]:.2g}" for i in range(10, steps + 1, 10))
        + f"; the FiLM positional table at the timing length ({film.input_conv.out_channels} x "
          f"{T_big}, arguments up to {T_big - 1}) card vs CPU {table:.3g}")
    log("WaveRNN card vs CPU: " + wavernn_against_cpu(gens["wavernn"], cpu_gens["wavernn"],
                                                       device)
        + f" (tol {VOCODER_TOL}) (phase 14 at {time.time() - t_phase:.0f} s)")
    del cpu_gens, wg_cpu
    log(f"vocoder fidelity replays on {device}: " + vocoder_fidelity(device) + f" | {card}")

    if cuda:
        vocoder_timings(gens, schedule, frames, configs["wavegrad"].audio.sample_rate, device,
                        card)

    # the surfaces: a Tacotron2 that stops at step 1, in the reference layout without an
    # "r", so that it decodes at the recipe's r = 6: 6 frames a sentence, which WaveRNN's
    # valid resnet conv (2 pad + 1 = 5 frames) can take
    with tempfile.TemporaryDirectory() as d:
        t2_dir = os.path.join(d, "t2")
        os.makedirs(t2_dir)
        t2 = random_tacotron2(t2_config, seed=0, stop_bias=T2_STOP_BIAS)
        torch.save({"model": {k: torch.from_numpy(v) for k, v in convert.reference_tacotron2_state(
            t2.module.state_dict()).items()}}, os.path.join(t2_dir, "model_file.pth"))
        write_json(os.path.join(t2_dir, "config.json"), t2.config.to_dict())
        del t2
        writers = {"parallel_wavegan": convert.reference_parallel_wavegan_state,
                   "univnet": convert.reference_univnet_state,
                   "wavegrad": convert.reference_wavegrad_state,
                   "wavernn": convert.reference_wavernn_state}
        paths = {}
        for k, writer in writers.items():
            vdir = os.path.join(d, k)
            os.makedirs(vdir)
            state = {n: v.cpu() for n, v in gens[k].state_dict().items()}
            torch.save({"model": {n: torch.from_numpy(v) for n, v in writer(state).items()}},
                       os.path.join(vdir, "model_file.pth"))
            write_json(os.path.join(vdir, "config.json"), configs[k].to_dict())
            paths[k] = ["--vocoder_path", os.path.join(vdir, "model_file.pth"),
                        "--vocoder_config_path", os.path.join(vdir, "config.json")]
        del gens, wg
        t2_args = ["--model_path", os.path.join(t2_dir, "model_file.pth"), "--config_path",
                   os.path.join(t2_dir, "config.json")]

        def by_path(k):
            return TTS(model_path=t2_args[1], config_path=t2_args[3], vocoder_path=paths[k][1],
                       vocoder_config_path=paths[k][3], device=device)

        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            for name, (vname, k) in ZOO_PAIRINGS.items():
                shutil.copytree(t2_dir, os.path.join(home, "tts_tpu", name.replace("/", "--")))
                shutil.copytree(os.path.dirname(paths[k][1]),
                                os.path.join(home, "tts_tpu", vname.replace("/", "--")))
                named = TTS(model_name=name, device=device)
                a = np.asarray(silent(named.tts, short), np.float32)
                b = np.asarray(silent(by_path(k).tts, short), np.float32)
                zerr = float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
                if zerr != 0 or a.std() == 0 or not np.isfinite(a).all():
                    raise AssertionError(f"TTS(model_name={name}) vs path load: {a.shape} vs "
                                         f"{b.shape}, max abs diff {zerr}")
                log(f"zoo: {name} with its default vocoder {vname} ({k}) from reference-layout "
                    f"directories, nothing fetched: {len(a)} samples, the short sentence differs "
                    f"from the path load by {zerr}")
                del named

        api = by_path("univnet")
        api_path, cli_path = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
        silent(api.tts_to_file, short, file_path=api_path)
        silent(synthesize_cli, ["--text", short, "--out_path", cli_path, "--device", str(device)]
               + t2_args + paths["univnet"])
        step, cli_sr = _int16_steps(cli_path, api_path)
        if step is None or step > 1:
            raise AssertionError(f"tts --vocoder_path (UnivNet) vs the API: {step} int16 steps")
        log(f"tts --model_path --config_path --vocoder_path --vocoder_config_path (UnivNet, its "
            f"noise from a generator seeded 0): at {cli_sr} Hz, at most {step} int16 step from "
            f"TTS.tts_to_file")
        wr_path = os.path.join(d, "wavernn.wav")
        t0 = time.perf_counter()
        silent(by_path("wavernn").tts_to_file, short, file_path=wr_path)
        log(f"WaveRNN TTS.tts_to_file (Tacotron2 stopping at step 1, 6 frames): "
            f"{os.path.getsize(wr_path)} bytes in {time.perf_counter() - t0:.1f} s, model load "
            f"included")
        status, body, said, dispatched = _serve_once(t2_args + paths["wavegrad"],
                                                     {"text": short}, device)
        if status != 200 or "serving serially" not in said or dispatched:
            raise AssertionError(f"Tacotron2 + WaveGrad server with --max_batch 4: {status}, "
                                 f"{said!r}")
        line = [ln for ln in said.splitlines() if "serially" in ln][0].strip()
        log(f"Tacotron2 + WaveGrad server (--vocoder_path, --max_batch 4): said {line!r}; "
            f"/api/tts answered {len(body)} bytes")

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during phase 14")
    line = ("ParallelWaveGAN, UnivNet, WaveGrad, WaveRNN, iSTFT: no hand-written kernel on these "
            "paths (decode_attention launches 0)")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 14 took {time.time() - t_phase:.1f} s | {card}")


ZOO_CAPACITRON = ("tts_models/en/blizzard2013/capacitron-t2-c50",
                  "tts_models/en/blizzard2013/capacitron-t2-c150_v2")
ZOO_BLIZZARD_HIFIGAN = "vocoder_models/en/blizzard2013/hifigan_v2"
STYLE_TOL = 1e-4  # card vs CPU, the style vectors, mels and waveforms of phase 15, fp32, TF32 off
STYLE_TEXT = "It is a lovely day for a walk."  # the Capacitron style reference's words (F37)


def blizzard_audio(spec_gain: float):
    """The blizzard2013 recipes' audio (24 kHz, trimmed at 60 dB, signal
    norm, mels 80-12000 Hz, ``np.log10``, ``ref_level_db`` 20, no
    preemphasis, ``min_level_db`` -100); ``spec_gain`` 25 in the Tacotron2
    recipe, 20 in the Tacotron v1 one."""
    from tts_tpu_torch.config.shared import BaseAudioConfig

    return BaseAudioConfig(sample_rate=24000, do_trim_silence=True, trim_db=60.0,
                           signal_norm=True, mel_fmin=80.0, mel_fmax=12000, spec_gain=spec_gain,
                           log_func="np.log10", ref_level_db=20, preemphasis=0.0,
                           min_level_db=-100)


def capacitron_t2_recipe_config():
    """``recipes/blizzard2013/tacotron2_capacitron/train_capacitron_t2.py``:
    Tacotron2 at full width with Capacitron 128 (capacity 150), ``r=2``,
    dynamic convolution attention, ``phoneme_cleaners`` with ``en-us``
    phonemes, 24 kHz; norms folded, as the zoo's converted checkpoints run."""
    from tts_tpu_torch.models.tacotron2 import Tacotron2Config

    return Tacotron2Config(
        audio=blizzard_audio(25.0), use_capacitron_vae=True,
        capacitron_vae={"capacitron_VAE_loss_alpha": 1.0, "capacitron_capacity": 150,
                        "capacitron_VAE_embedding_dim": 128},
        r=2, attention_type="dynamic_convolution", text_cleaner="phoneme_cleaners",
        use_phonemes=True, phoneme_language="en-us", stopnet_pos_weight=15, norm_type="folded")


def gst_t2_config():
    """Tacotron2 with GST at the JAX package's GST defaults (512 wide, 4
    heads, 10 tokens), the ``Tacotron2Config`` defaults otherwise (22.05 kHz,
    location-sensitive attention, ``r=2``), ``phoneme_cleaners`` with
    ``en-us`` phonemes; norms folded."""
    from tts_tpu_torch.models.tacotron2 import Tacotron2Config

    return Tacotron2Config(use_gst=True, text_cleaner="phoneme_cleaners", use_phonemes=True,
                           phoneme_language="en-us", norm_type="folded")


def capacitron_t1_recipe_config():
    """``recipes/blizzard2013/tacotron1_capacitron/train_capacitron_t1.py``:
    the ``TacotronConfig`` defaults (embedding 256, CBHG 128 with banks of
    16 and 8, 1024-wide decoder LSTMs, 513 linear bins) with Capacitron 128,
    ``r=2``, ``phoneme_cleaners`` with ``en-us`` phonemes, 24 kHz. Its
    ``graves`` attention is not read: the JAX network keeps the Tacotron2
    cell's location-sensitive attention (F41)."""
    from tts_tpu_torch.models.tacotron2 import TacotronConfig

    return TacotronConfig(
        audio=blizzard_audio(20.0), use_capacitron_vae=True,
        capacitron_vae={"capacitron_VAE_loss_alpha": 1.0, "capacitron_VAE_embedding_dim": 128},
        r=2, attention_type="graves", attention_heads=5, text_cleaner="phoneme_cleaners",
        use_phonemes=True, phoneme_language="en-us", stopnet_pos_weight=15)


def never_stopping(model, seed: int = 0):
    """``model`` (a Tacotron2 or Tacotron wrapper) with fp32 weights from
    ``seed`` on the CPU and the stopnet's weight 0, bias -10: every decode
    runs its budget."""
    import torch

    model.init_params(seed=seed, device="cpu")
    with torch.no_grad():
        model.module.decoder_cell.stopnet.weight.zero_()
        model.module.decoder_cell.stopnet.bias.fill_(-10.0)
    return model


def style_vectors(model, text: str, style_mel, device) -> dict:
    """The style vectors a decode of ``text`` appends to the encoder
    outputs: the GST's of ``style_mel``, Capacitron's ``z`` of its posterior
    and of its prior (each drawn on the host from a generator seeded 0)."""
    import torch

    m = model.module
    x, xl = t2_ids(model, [text], device)
    mel = torch.from_numpy(style_mel).to(device)
    out = {}
    with torch.no_grad():
        if hasattr(m, "gst_layer"):
            out["GST style"] = m.gst_layer(mel).float().cpu().numpy()
        if hasattr(m, "capacitron_vae_layer"):
            D = m.capacitron_vae_layer.embedding_dim
            for what, ref in (("Capacitron z (posterior)", mel), ("Capacitron z (prior)", None)):
                enc = m._encode(x, xl, style_mel=ref, generator=torch.Generator().manual_seed(0))
                out[what] = enc[:, 0, -D:].float().cpu().numpy()
    return out


def compare_style_path(name: str, synth, cpu_synth, style_wav: str, device, card: str,
                       griffin_lim: bool = False) -> str:
    """``name`` card against CPU on the short sentence: the style vectors
    (:func:`style_vectors`), then the whole budget through ``synthesis``
    with the style reference (a mel, or Tacotron v1's linear spectrogram)
    and its audio (the vocoder's, or Griffin-Lim's after one
    ``np.random.seed``). Returns the log line."""
    from tts_tpu_torch.utils.synthesis import synthesis

    short = VITS_SENTENCES["short"]
    model, cpu_model = synth.tts_model, cpu_synth.tts_model
    style_mel = synth.ap.melspectrogram(synth.ap.load_wav(style_wav)).T[None]
    errs = {}
    card_vec, cpu_vec = (style_vectors(m, short, style_mel, dev) for m, dev in
                         ((model, device), (cpu_model, "cpu")))
    for what in card_vec:
        errs[what] = float(np.abs(card_vec[what] - cpu_vec[what]).max())
    outs = []
    for s, m in ((synth, model), (cpu_synth, cpu_model)):
        np.random.seed(0)
        outs.append(synthesis(m, short, style_wav=style_wav, ap=s.ap,
                              use_griffin_lim=griffin_lim, style_text=STYLE_TEXT))
    g, w = outs
    g_len, w_len = (int(o["outputs"]["mel_lengths"][0]) for o in outs)
    if g_len != w_len or g["model_outputs"].shape != w["model_outputs"].shape:
        raise AssertionError(f"{name}: mel_lengths card {g_len} != CPU {w_len}")
    errs["linear spectrogram" if griffin_lim else "mel"] = float(
        np.abs(g["model_outputs"] - w["model_outputs"]).max())
    if griffin_lim:
        gw, ww = g["wav"], w["wav"]
        errs["mel"] = float(np.abs(g["outputs"]["decoder_outputs"][0].cpu().numpy()
                                   - w["outputs"]["decoder_outputs"][0].numpy()).max())
    else:
        gw, ww = synth._vocode(g["model_outputs"]), cpu_synth._vocode(w["model_outputs"])
    audio = float(np.abs(gw - ww).max()) if gw.shape == ww.shape else np.inf
    if griffin_lim:
        # the phase Griffin-Lim rebuilds drifts with 1e-6 differences of its input over its 60
        # iterations; the magnitude it rebuilds does not: the relative L2 distance of the two
        # waveforms' magnitude spectrograms is the check, the waveforms' peak share is printed
        from tts_tpu_torch.audio.numpy_transforms import stft

        mag_g, mag_w = (np.abs(stft(y=w_, **synth.ap._stft_kwargs())) for w_ in (gw, ww))
        spectral = float(np.linalg.norm(mag_g - mag_w) / np.linalg.norm(mag_w))
        audio /= float(np.abs(ww).max())
    bad = {k: v for k, v in errs.items() if not v <= STYLE_TOL}
    if bad or not (spectral <= GL_REL_TOL if griffin_lim else audio <= STYLE_TOL) \
            or not np.isfinite(gw).all() or gw.std() == 0:
        raise AssertionError(f"{name} card vs CPU: {errs}, audio {audio} (tol {STYLE_TOL}; "
                             f"Griffin-Lim's magnitude {GL_REL_TOL})")
    audio_line = (f"Griffin-Lim audio: magnitude spectrogram {spectral:.3g} relative L2 (tol "
                  f"{GL_REL_TOL}), waveform {audio:.3g} of its peak (printed)" if griffin_lim
                  else f"audio {audio:.3g} (tol {STYLE_TOL})")
    return (f"{name}, short sentence with a style reference, card vs CPU at its whole budget "
            f"(mel_lengths {g_len} equal): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {STYLE_TOL}); {audio_line} | {card}")


def style_latency(name: str, synth, style_wav: str, device, card: str,
                  griffin_lim: bool = False) -> None:
    """The medium sentence with a style reference at natural length (3
    decode steps a token): latency and RTF (one call), ms per decode step
    (the slope between 100 and 300 steps), and the kernels and busy share of
    one call under ``torch.profiler``; the vocoder's (or Griffin-Lim's) part
    of it."""
    import torch

    model, medium = synth.tts_model, VITS_SENTENCES["medium"]
    aux = {"style_mel": torch.from_numpy(
        synth.ap.melspectrogram(synth.ap.load_wav(style_wav)).T[None]).to(device)}
    n_tokens = len(model.tokenizer.text_to_ids(medium))
    x, xl = t2_ids(model, [medium], device)
    parts = {}

    def natural():
        t0 = time.perf_counter()
        with torch.no_grad():
            o = model.inference(x, xl, max_steps=3 * n_tokens, aux_input=aux)
            out = o["model_outputs"][0, : int(o["mel_lengths"][0])].float().cpu().numpy()
        t1 = time.perf_counter()
        wav = synth.ap.inv_spectrogram(out.T) if griffin_lim else synth._vocode(out)
        sync(device)
        parts.update(model=(t1 - t0) * 1e3, vocoder=(time.perf_counter() - t1) * 1e3,
                     seconds=len(wav) / synth.output_sample_rate)

    ms, lo, hi = median_ms(natural, device, reps=1)
    step = step_ms(lambda n: model.inference(x, xl, max_steps=n, aux_input=aux), device, 100, 300)
    vocoder = "Griffin-Lim (host)" if griffin_lim else "HiFiGAN"
    log(f"{name}, medium sentence with a style reference ({n_tokens} tokens) at natural length "
        f"({3 * n_tokens} steps): {parts['seconds']:.2f} s of audio in {ms:.1f} ms (one call), "
        f"RTF {parts['seconds'] / ms * 1e3:.2f}; model {parts['model']:.1f} "
        f"ms, {vocoder} {parts['vocoder']:.1f} ms; decode step {step:.3f} ms wall (the slope "
        f"between 100 and 300 steps, median of 3) | {card}")
    profile_call(natural, f"{name}, medium sentence at natural length", card)


def phase_style_tacotron(card: str, device="cuda", cut=None) -> None:
    """GST and Capacitron on Tacotron2, then Tacotron v1: the blizzard2013
    Capacitron Tacotron2 recipe with a 24 kHz HiFiGAN, saved in the
    reference layout and driven by the zoo's two Capacitron names through
    ``TTS``, ``tts --style_wav --capacitron_style_text`` and
    ``/api/tts?style_wav=``, with and without a style reference; a GST
    Tacotron2 at the GST defaults with the LJSpeech HiFiGAN; the blizzard2013
    Capacitron Tacotron v1 recipe with Griffin-Lim, from the port's own
    checkpoint. Each card against CPU (style vectors, mel, audio), with the
    medium sentence's latency, ms per step and busy share.
    ``decode_attention`` must not launch. ``cut(cap, gst, t1, blizzard_voc,
    ljspeech_voc)`` shrinks the configs in place, for rehearsals on the
    CPU."""
    import io
    import shutil

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.tacotron2 import Tacotron, Tacotron2
    from tts_tpu_torch.models.tacotron2.model import gst_settings
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.utils.convert import reference_tacotron2_state
    from tts_tpu_torch.utils.synthesizer import Synthesizer
    from tts_tpu_torch.vocoder.configs import HifiganConfig

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    short = VITS_SENTENCES["short"]

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    cap, gst, t1 = capacitron_t2_recipe_config(), gst_t2_config(), capacitron_t1_recipe_config()
    blizzard_voc = HifiganConfig(audio=blizzard_audio(25.0))
    ljspeech_voc = hifigan_recipe_config()
    (cut or (lambda *configs: None))(cap, gst, t1, blizzard_voc, ljspeech_voc)
    with tempfile.TemporaryDirectory() as d:
        style_wav = os.path.join(d, "style.wav")
        scipy.io.wavfile.write(style_wav, 24000, reference_wav(3.0, 24000, seed=5))

        def save(name, model, reference=True):
            path = os.path.join(d, name)
            os.makedirs(path)
            state = model.module.state_dict()
            if reference:
                torch.save({"model": {k: torch.from_numpy(v) for k, v in
                                      reference_tacotron2_state(state).items()}},
                           os.path.join(path, "model_file.pth"))
            else:
                torch.save(state, os.path.join(path, "model_torch.pt"))
            write_json(os.path.join(path, "config.json"), model.config.to_dict())
            return sum(p.numel() for p in model.module.parameters())

        def save_vocoder(name, config):
            path = os.path.join(d, name)
            os.makedirs(path)
            gen = random_vocoder(config, seed=0)
            torch.save({"model": {"model_g." + k: v for k, v in gen.state_dict().items()}},
                       os.path.join(path, "model_file.pth"))
            write_json(os.path.join(path, "config.json"), config.to_dict())

        def load(name, dev, vocoder=None, weights="model_file.pth"):
            voc = {} if vocoder is None else dict(
                vocoder_checkpoint=os.path.join(d, vocoder, "model_file.pth"),
                vocoder_config=os.path.join(d, vocoder, "config.json"))
            return Synthesizer(tts_checkpoint=os.path.join(d, name, weights),
                               tts_config_path=os.path.join(d, name, "config.json"),
                               device=dev, **voc)

        n = {"cap": save("cap", never_stopping(Tacotron2.init_from_config(cap))),
             "gst": save("gst", never_stopping(Tacotron2.init_from_config(gst))),
             "t1": save("t1", never_stopping(Tacotron.init_from_config(t1)), reference=False)}
        save_vocoder("blizzard_voc", blizzard_voc)
        save_vocoder("ljspeech_voc", ljspeech_voc)
        g = gst_settings(gst)
        log(f"Capacitron Tacotron2 (blizzard2013 recipe: {cap.attention_type} attention, r "
            f"{cap.r}, Capacitron {cap.capacitron_vae['capacitron_VAE_embedding_dim']}, "
            f"{cap.audio.sample_rate} Hz) {n['cap'] / 1e6:.2f} M; GST Tacotron2 "
            f"({g['gst_embedding_dim']} wide, {g['num_heads']} heads, {g['num_style_tokens']} "
            f"tokens) {n['gst'] / 1e6:.2f} M; Capacitron Tacotron v1 (blizzard2013 T1 recipe: "
            f"CBHG {t1.cbhg_features}, K {t1.cbhg_K} and {t1.post_cbhg_K}, {t1.out_channels} "
            f"linear bins) {n['t1'] / 1e6:.2f} M; phonemes en-us; weights from seed 0, stopnet "
            f"weight 0, bias -10 (never stops); HiFiGAN at 24 kHz (blizzard) and 22.05 kHz "
            f"| {card}")

        for name, key, vocoder, weights, gl in (
                ("Capacitron Tacotron2 + HiFiGAN", "cap", "blizzard_voc", "model_file.pth", False),
                ("GST Tacotron2 + HiFiGAN", "gst", "ljspeech_voc", "model_file.pth", False),
                ("Capacitron Tacotron v1 + Griffin-Lim", "t1", None, "model_torch.pt", True)):
            synth = load(key, device, vocoder, weights)
            cpu_synth = load(key, "cpu", vocoder, weights)
            log(compare_style_path(name, synth, cpu_synth, style_wav, device, card, gl)
                + f" (phase 15 at {time.time() - t_phase:.0f} s)")
            del cpu_synth
            if cuda:
                style_latency(name, synth, style_wav, device, card, gl)
                log(f"(phase 15 at {time.time() - t_phase:.0f} s)")
            del synth

        # the zoo's two Capacitron voices by name, with and without a style reference
        with tempfile.TemporaryDirectory() as home, offline_zoo(home):
            for zoo_name in ZOO_CAPACITRON:
                shutil.copytree(os.path.join(d, "cap"),
                                os.path.join(home, "tts_tpu", zoo_name.replace("/", "--")))
            shutil.copytree(os.path.join(d, "blizzard_voc"), os.path.join(
                home, "tts_tpu", ZOO_BLIZZARD_HIFIGAN.replace("/", "--")))
            by_path = load("cap", device, "blizzard_voc")
            want = np.asarray(silent(by_path.tts, short, style_wav=style_wav), np.float32)
            want_prior = np.asarray(silent(by_path.tts, short), np.float32)
            for zoo_name in ZOO_CAPACITRON:
                tts = TTS(model_name=zoo_name, device=device)
                styled = np.asarray(silent(tts.tts, short, style_wav=style_wav,
                                           style_text=STYLE_TEXT), np.float32)
                prior = np.asarray(silent(tts.tts, short), np.float32)
                if not (np.array_equal(styled, want) and np.array_equal(prior, want_prior)):
                    raise AssertionError(f"TTS(model_name={zoo_name}) vs the path load")
                del tts
            if np.array_equal(want, want_prior) or want.std() == 0:
                raise AssertionError("Capacitron: the style reference changed nothing")
            log(f"zoo: {', '.join(ZOO_CAPACITRON)} with {ZOO_BLIZZARD_HIFIGAN} from "
                f"reference-layout directories, nothing fetched: with a style_wav and without "
                f"(the prior), each equal to the path load; the two differ by "
                f"{float(np.abs(want - want_prior).max()):.3g}")

            api_path, cli_path = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
            silent(by_path.save_wav, want, api_path)
            silent(synthesize_cli, ["--text", short, "--model_name", ZOO_CAPACITRON[0],
                                    "--capacitron_style_wav", style_wav,
                                    "--capacitron_style_text", STYLE_TEXT,
                                    "--out_path", cli_path, "--device", str(device)])
            step, sr = _int16_steps(cli_path, api_path)
            if step is None or step > 1:
                raise AssertionError(f"tts --model_name --capacitron_style_wav: {step} int16 "
                                     f"steps from the API")
            status, body, said, dispatched = _serve_once(
                ["--model_name", ZOO_CAPACITRON[1]], {"text": short, "style_wav": style_wav},
                device)
            with open(os.path.join(d, "srv.wav"), "wb") as f:
                f.write(body)
            srv_step, _ = _int16_steps(os.path.join(d, "srv.wav"), api_path)
            if status != 200 or srv_step is None or srv_step > 1 or dispatched:
                raise AssertionError(f"/api/tts?style_wav=: {status}, {srv_step} int16 steps, "
                                     f"batches {dispatched}")
            log(f"tts --model_name {ZOO_CAPACITRON[0]} --capacitron_style_wav "
                f"--capacitron_style_text: {step} int16 step from the API; /api/tts?style_wav= "
                f"on {ZOO_CAPACITRON[1]} (--max_batch 4, served serially): {srv_step} int16 step; "
                f"{sr} Hz | {card}")
            del by_path

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the style phase")
    line = ("GST, Capacitron and Tacotron v1: no hand-written kernel on these paths "
            "(decode_attention launches 0)")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 15 took {time.time() - t_phase:.1f} s | {card}")


ZOO_FREEVC = "voice_conversion_models/multilingual/vctk/freevc24"
FREEVC_TOL = 1e-4  # card vs CPU, the speaker embedding and the waveform, fp32 with TF32 off
WAVLM_FEATURE_TOL = 1e-4  # card vs CPU, WavLM-Large's features, as a share of their peak
WAVLM_SOURCES_S = (3.0, 10.0)  # the sources WavLM is timed on


def random_wavlm(cfg, seed: int = 0):
    """``tts_tpu_torch.vc.modules.wavlm.WavLM`` for ``cfg`` on the CPU, fp32
    weights drawn from ``seed``: linear and conv weights N(0, 1/fan_in),
    biases 0, norms the identity, the relative-position table N(0, 1) (as
    the reference's ``nn.Embedding`` draws it), ``grep_a`` ones."""
    import torch

    from tts_tpu_torch.vc.modules.wavlm import WavLM

    model = WavLM(cfg)
    draw = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(owner, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "grep_a":
                p.fill_(1.0)
            elif leaf == "relative_attention_bias":
                p.copy_(torch.randn(p.shape, generator=draw))
            else:
                p.copy_(torch.randn(p.shape, generator=draw) / p[0].numel() ** 0.5)
    return model.eval().requires_grad_(False)


def vc_stage_ms(vcm, src: str, tgt: str, device) -> dict:
    """Median ms of each stage of ``FreeVC.voice_conversion_from_files``, run
    one by one: the two wav loads (the target resampled), the target's
    speaker embedding (mel and ``enc_spk``), WavLM, the decode and the copy
    to the host."""
    import torch

    from tts_tpu_torch.audio.numpy_transforms import load_wav

    sr = vcm.config.audio.input_sample_rate
    wavs = [load_wav(filename=p, sample_rate=sr, resample=True) for p in (src, tgt)]
    x = torch.from_numpy(wavs[0])[None].to(device)
    with torch.no_grad():
        c = vcm.content_extractor(x)
        g = vcm.embed_target_speaker(wavs[1])
        out = vcm.voice_conversion(c, torch.tensor([c.shape[1]], device=device), g)
        parts = {
            "wav loads": lambda: [load_wav(filename=p, sample_rate=sr, resample=True)
                                  for p in (src, tgt)],
            "target embedding": lambda: vcm.embed_target_speaker(wavs[1]),
            "WavLM": lambda: vcm.content_extractor(x),
            "decode": lambda: vcm.voice_conversion(
                c, torch.tensor([c.shape[1]], device=device), g),
            "to host": lambda: out.float().cpu().numpy(),
        }
        return {k: median_ms(fn, device)[0] for k, fn in parts.items()}


def conv_rows(fn, what: str, card: str, top: int = 4) -> None:
    """The convolutions of one call of ``fn`` that take the most device time,
    by input shape (``torch.profiler`` with shapes recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key in ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose")]
    total = sum(e.device_time_total for e in rows)
    log(f"convolutions of {what}: {total / 1e3:.2f} ms of device time in "
        f"{sum(e.count for e in rows)} calls | {card}")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:top]:
        log(f"  {e.device_time_total / 1e3:8.3f} ms {e.count:4d}x  {e.key} "
            f"{str(e.input_shapes[:2])[:90]}")


def phase_voice_conversion(card: str, device="cuda", cut=None) -> None:
    """FreeVC with WavLM-Large, the zoo's ``freevc24``: random weights from
    seed 0 at full width written in the reference layout (WavLM-Large to
    ``$TTS_HOME/wavlm/WavLM-Large.pt``, FreeVC at ``FreeVCConfig()`` as the
    zoo directory's ``model.pth`` and ``config.json``), card against CPU on a
    3 s source and a 3 s target (WavLM's features, the target embedding,
    the waveform on host noise), the timings, the zoo name, ``tts
    --source_wav --target_wav`` and ``tts_with_vc_to_file`` on phase 6's
    LJSpeech VITS. ``decode_attention`` must not launch. ``cut(wavlm_cfg,
    freevc_config, vits_config)`` shrinks the configs in place, for
    rehearsals on the CPU."""
    import io

    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.audio.numpy_transforms import load_wav
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.utils.convert import reference_freevc_state, reference_wavlm_state
    from tts_tpu_torch.utils.synthesizer import Synthesizer
    from tts_tpu_torch.vc.configs import FreeVCConfig
    from tts_tpu_torch.vc.models.freevc import FreeVC
    from tts_tpu_torch.vc.modules.wavlm import load_wavlm, wavlm_large_config

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    decode_attention.launches = 0  # K1 is not on this path: the count must stay 0
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    wl_cfg, vc_config, vits_config = wavlm_large_config(), FreeVCConfig(), vits_recipe_config()
    (cut or (lambda *configs: None))(wl_cfg, vc_config, vits_config)
    a = vc_config.model_args
    with tempfile.TemporaryDirectory() as home, offline_zoo(home):
        os.makedirs(os.path.join(home, "wavlm"))
        wl = random_wavlm(wl_cfg, seed=0)
        n_wavlm = sum(p.numel() for p in wl.parameters())
        torch.save({"cfg": wl_cfg.to_checkpoint_cfg(),
                    "model": {k: torch.from_numpy(v)
                              for k, v in reference_wavlm_state(wl.state_dict()).items()}},
                   os.path.join(home, "wavlm", "WavLM-Large.pt"))
        del wl
        zoo = os.path.join(home, "tts_tpu", ZOO_FREEVC.replace("/", "--"))
        os.makedirs(zoo)
        vc = FreeVC(vc_config).init_params(seed=0, device="cpu")
        n_freevc = sum(p.numel() for p in vc.module.parameters())
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              reference_freevc_state(vc.module.state_dict()).items()}},
                   os.path.join(zoo, "model.pth"))
        write_json(os.path.join(zoo, "config.json"), vc_config.to_dict())
        del vc
        hop = int(np.prod(a.upsample_rates))
        log(f"WavLM-Large ({wl_cfg.encoder_layers} layers, {wl_cfg.encoder_embed_dim} wide, "
            f"{wl_cfg.encoder_attention_heads} heads, buckets {wl_cfg.num_buckets}/"
            f"{wl_cfg.max_distance}) {n_wavlm / 1e6:.2f} M ({4 * n_wavlm / 1e9:.2f} GB fp32); "
            f"FreeVC (FreeVCConfig(): {a.spec_channels} spec bins, {a.hidden_channels} wide, "
            f"HiFiGAN from {a.upsample_initial_channel} channels x {a.upsample_rates}, gin "
            f"{a.gin_channels}, ssl_dim {a.ssl_dim}, enc_spk) {n_freevc / 1e6:.2f} M; reference "
            f"layout, weights from seed 0 | {card}")

        sr_in = vc_config.audio.input_sample_rate
        src, tgt = os.path.join(home, "src.wav"), os.path.join(home, "tgt.wav")
        scipy.io.wavfile.write(src, sr_in, reference_wav(3.0, sr_in, seed=6))
        scipy.io.wavfile.write(tgt, 22050, reference_wav(3.0, 22050, seed=7))

        def load(dev):
            return Synthesizer(vc_checkpoint=os.path.join(zoo, "model.pth"),
                               vc_config=os.path.join(zoo, "config.json"), device=dev)

        synth, cpu_synth = load(device), load("cpu")
        t0 = time.time()
        synth.vc_model.content_extractor = load_wavlm(device=device)
        log(f"load_wavlm: {time.time() - t0:.1f} s (torch.load, reference layout → the port's "
            f"state, to the device)")
        cpu_synth.vc_model.content_extractor = load_wavlm(device="cpu")
        vcm, cpu_vcm = synth.vc_model, cpu_synth.vc_model
        src16 = reference_wav(3.0, sr_in, seed=6)
        tgt16 = load_wav(filename=tgt, sample_rate=sr_in, resample=True)
        with torch.no_grad():
            feats = vcm.content_extractor(torch.from_numpy(src16)[None].to(device)).cpu()
            cpu_feats = cpu_vcm.content_extractor(torch.from_numpy(src16)[None])
            emb = vcm.embed_target_speaker(tgt16).cpu()
            cpu_emb = cpu_vcm.embed_target_speaker(tgt16)
        feat_err = float((feats - cpu_feats).abs().max()) / float(cpu_feats.abs().max())
        emb_err = float((emb - cpu_emb).abs().max())
        with host_noise(0):
            out = np.asarray(silent(synth.voice_conversion, src, tgt), np.float32)
            cpu_out = np.asarray(silent(cpu_synth.voice_conversion, src, tgt), np.float32)
        wav_err = float(np.abs(out - cpu_out).max())
        frames = feats.shape[1]
        log(f"card vs CPU, 3 s source, 3 s target (22.05 kHz, resampled), host noise: WavLM "
            f"features [{frames}, {feats.shape[2]}] {feat_err:.3g} of their peak "
            f"{float(cpu_feats.abs().max()):.3g} (tolerance {WAVLM_FEATURE_TOL:g}); target "
            f"embedding {emb_err:.3g}; waveform {wav_err:.3g} (tolerance {FREEVC_TOL:g}) over "
            f"{len(out)} samples, peak {float(np.abs(cpu_out).max()):.3g} | {card}")
        if not (np.isfinite(out).all() and out.shape == cpu_out.shape == (frames * hop,)
                and np.abs(out).max() > 0):
            raise AssertionError(f"FreeVC output: shape {out.shape}, {frames} frames x {hop}")
        if feat_err > WAVLM_FEATURE_TOL or emb_err > FREEVC_TOL or wav_err > FREEVC_TOL:
            raise AssertionError(f"card vs CPU: features {feat_err}, embedding {emb_err}, "
                                 f"waveform {wav_err}")
        del cpu_synth, cpu_vcm
        gc.collect()
        sr_out = synth.output_sample_rate
        log(f"output rate (F42): {len(out)} samples for a 3.0 s source = {hop} a WavLM frame, "
            f"{len(out) / 3.0:.0f} a second, labelled {sr_out} Hz: {len(out) / sr_out:.3f} s "
            f"of audio, {3.0 * sr_out / len(out):.2f}x fast | {card}")

        if cuda:
            for seconds in WAVLM_SOURCES_S:
                x = torch.from_numpy(reference_wav(seconds, sr_in, seed=8))[None].to(device)
                with torch.no_grad():
                    ms = cuda_ms(lambda: vcm.content_extractor(x))
                    n = vcm.content_extractor(x).shape[1]
                    kernels, device_us = kernels_and_device_us(lambda: vcm.content_extractor(x))
                log(f"WavLM-Large on a {seconds:.0f} s source ({n} frames): {ms:.2f} ms "
                    f"(CUDA events, median of 5); {kernels} kernels, {device_us / 1e3:.2f} ms of "
                    f"device time (torch.profiler) | {card}")
            with torch.no_grad():
                conv_rows(lambda: vcm.content_extractor(x[:, :int(3.0 * sr_in)]),
                          "WavLM-Large on 3 s", card)
            c = feats.to(device)
            lengths = torch.tensor([frames], device=device)
            g = emb.to(device)
            decode = cuda_ms(lambda: vcm.voice_conversion(c, lengths, g))
            kernels, device_us = kernels_and_device_us(lambda: vcm.voice_conversion(c, lengths, g))
            log(f"FreeVC decode (enc_p, flow in reverse, HiFiGAN) on {frames} frames → "
                f"{frames * hop} samples: {decode:.2f} ms (CUDA events, median of 5); {kernels} "
                f"kernels, {device_us / 1e3:.2f} ms of device time (torch.profiler) | {card}")
            med, lo, hi = median_ms(lambda: silent(synth.voice_conversion, src, tgt), device)
            log(f"voice_conversion_from_files, 3 s source, 3 s target: {med:.1f} ms (min "
                f"{lo:.1f}, max {hi:.1f}, median of 5): {3.0 / (med / 1e3):.1f} source s per "
                f"wall s, {len(out) / sr_out / (med / 1e3):.1f} output s (at the labelled "
                f"{sr_out} Hz) per wall s | {card}")
            profile_call(lambda: silent(synth.voice_conversion, src, tgt),
                         "voice_conversion_from_files (3 s source)", card)
            stages = vc_stage_ms(vcm, src, tgt, device)
            log("stages of voice_conversion_from_files (host clock, synchronized, median of "
                "5): " + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()) + f" | {card}")
            conv_rows(lambda: vcm.voice_conversion(c, lengths, g), "the FreeVC decode", card)
        log(f"(phase 16 at {time.time() - t_phase:.0f} s)")

        # the zoo's name, the command line, and TTS into the converter
        tts = TTS(model_name=ZOO_FREEVC, device=device)
        by_name = np.asarray(silent(tts.voice_conversion, source_wav=src, target_wav=tgt),
                             np.float32)
        by_path = np.asarray(silent(synth.voice_conversion, src, tgt), np.float32)
        if not np.array_equal(by_name, by_path):
            raise AssertionError(f"TTS(model_name={ZOO_FREEVC}) vs the path load: "
                                 f"{float(np.abs(by_name - by_path).max())}")
        api_path, cli_path = os.path.join(home, "api.wav"), os.path.join(home, "cli.wav")
        silent(tts.voice_conversion_to_file, source_wav=src, target_wav=tgt, file_path=api_path)
        del tts
        silent(synthesize_cli, ["--model_name", ZOO_FREEVC, "--source_wav", src,
                                "--target_wav", tgt, "--out_path", cli_path,
                                "--device", str(device)])
        step, sr = _int16_steps(cli_path, api_path)
        if step is None or step > 1 or sr != sr_out:
            raise AssertionError(f"tts --source_wav --target_wav: {step} int16 steps, {sr} Hz")
        log(f"zoo: {ZOO_FREEVC} from a reference-layout directory, WavLM from "
            f"$TTS_HOME/wavlm/, nothing fetched: equal to the path load; tts --model_name "
            f"--source_wav --target_wav: {step} int16 step from voice_conversion_to_file; "
            f"{sr} Hz | {card}")

        vits_dir = os.path.join(home, "vits")
        os.makedirs(vits_dir)
        save_model_dir(vits_config, vits_dir)
        tts = TTS(model_path=vits_dir, device=device)
        with_vc, spoken = os.path.join(home, "with_vc.wav"), os.path.join(home, "spoken.wav")
        text = VITS_SENTENCES["short"]
        t0 = time.time()
        silent(tts.tts_with_vc_to_file, text, speaker_wav=tgt, file_path=with_vc)
        first = time.time() - t0
        silent(tts.tts_to_file, text, file_path=spoken)
        want = np.asarray(silent(tts.voice_converter.voice_conversion, spoken, tgt), np.float32)
        silent(tts.voice_converter.save_wav, want, os.path.join(home, "want.wav"))
        step, sr = _int16_steps(with_vc, os.path.join(home, "want.wav"))
        if step is None or step > 1 or sr != sr_out:
            raise AssertionError(f"tts_with_vc_to_file: {step} int16 steps, {sr} Hz")
        log(f"tts_with_vc_to_file: phase 6's LJSpeech VITS by path, {ZOO_FREEVC} loaded by "
            f"name on first use ({first:.1f} s with that load): {step} int16 step from "
            f"voice_conversion of the VITS file; {sr} Hz | {card}")
        del tts, synth, vcm

    if decode_attention.launches:
        raise AssertionError(f"decode_attention launched {decode_attention.launches} times "
                             f"during the voice-conversion phase")
    line = ("FreeVC with WavLM-Large: no hand-written kernel on this path "
            "(decode_attention launches 0)")
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f"; phase 16 took {time.time() - t_phase:.1f} s | {card}")


# ---------------------------------------------------------------------------
XTTS_V1 = "tts_models/multilingual/multi-dataset/xtts_v1.1"
XTTS_V1_CLIP_S = 30.0  # the default gpt_cond_len: 646 prompt latents
XTTS_V1_TOKENS = 40


def phase_xtts_v1(card: str, device="cuda", cut=None) -> int:
    """XTTS v1 at full XTTS width (``XttsConfig()`` without the perceiver,
    random fp32 weights from seed 0): a 30 s reference clip conditions one
    latent a coarse mel frame; 40 greedy tokens through K1 and through the
    plain attention on the card must be identical (latents within 1e-4) and
    launch K1 30 times a step; the TTFA parts and ms a decode step behind
    the long prompt; ``xtts_v1.1`` by zoo name against the path load.
    ``cut(config)`` shrinks the config in place, for rehearsals on the CPU.
    Returns K1's launches on this path."""
    import shutil

    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.audio.numpy_transforms import save_wav
    from tts_tpu_torch.models.xtts.config import XttsConfig
    from tts_tpu_torch.models.xtts.model import Xtts
    from tts_tpu_torch.models.xtts.tokenizer import VoiceBpeTokenizer, write_char_vocab
    from tts_tpu_torch.ops.decode_attention import decode_attention

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    config = XttsConfig()
    config.model_args.gpt_use_perceiver_resampler = False
    (cut or (lambda c: None))(config)
    with built_on(device):
        model = Xtts(config)
    model.init_params(seed=0, device=device, dtype=torch.float32)
    n_layers = len(model.gpt.gpt.h)
    D = model.args.gpt_n_model_channels
    wav = reference_wav(seconds=XTTS_V1_CLIP_S)
    sync(device)
    t0 = time.perf_counter()
    cond = model.get_gpt_cond_latents(wav, 22050)
    sync(device)
    cond_ms = (time.perf_counter() - t0) * 1e3
    n_cond = int(XTTS_V1_CLIP_S * 22050) // 1024 + 1
    if cond.shape != (1, n_cond, D) or not torch.isfinite(cond).all():
        raise AssertionError(f"v1 conditioning {tuple(cond.shape)}, want (1, {n_cond}, {D})")
    n_text = min(200, model.args.gpt_number_text_tokens)
    text = torch.from_numpy(np.random.RandomState(0).randint(5, n_text, (1, 40))).to(device)
    lengths = torch.tensor([40], device=device)
    kw = dict(max_new_tokens=XTTS_V1_TOKENS, temperature=0.75, top_k=1, top_p=0.85,
              repetition_penalty=5.0)
    decode_attention.launches = 0
    steps = model.gpt.decode_steps
    with_kernel = model.gpt.generate(cond, text, lengths, None, **kw)
    sync(device)
    launches = decode_attention.launches
    run_steps = model.gpt.decode_steps - steps
    if cuda and launches != n_layers * run_steps:
        raise AssertionError(f"XTTS v1: {launches} K1 launches for {run_steps} steps")
    with plain_decode_attention():
        with_plain = model.gpt.generate(cond, text, lengths, None, **kw)
    sync(device)
    if decode_attention.launches != launches:
        raise AssertionError("the plain run launched the kernel")
    if not torch.equal(with_kernel["codes"], with_plain["codes"]):
        raise AssertionError(f"XTTS v1 tokens differ:\n{with_kernel['codes']}\n"
                             f"{with_plain['codes']}")
    lat_err = (with_kernel["latents"] - with_plain["latents"]).abs().max().item()
    if not lat_err <= 1e-4:
        raise AssertionError(f"XTTS v1 latents differ by {lat_err} > 1e-4")
    cache = n_cond + 42 + 1 + XTTS_V1_TOKENS
    log(f"XTTS v1 (no perceiver): {n_layers} layers, width {D}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters (seed 0); a "
        f"{XTTS_V1_CLIP_S:.0f} s clip gives {n_cond} prompt latents in {cond_ms:.1f} ms; "
        f"{XTTS_V1_TOKENS} greedy tokens identical through K1 and the plain attention, latents "
        f"max abs diff {lat_err:.3g} (tol 1e-4); K1 launched {launches} times = {n_layers} x "
        f"{run_steps} steps, the cache reaching {cache} keys | {card}")

    with tempfile.TemporaryDirectory() as d:
        ref = os.path.join(d, "ref.wav")
        save_wav(wav=wav, path=ref, sample_rate=22050)
        vocab = os.path.join(d, "vocab.json")
        write_char_vocab(vocab, "abcdefghijklmnopqrstuvwxyz.,!?'-")
        model.tokenizer = VoiceBpeTokenizer(vocab_file=vocab)
        parts = ttfa_parts(model, ref, "this is the first sentence of a long reply.", device)
        log("XTTS v1 time to first audio on an idle device, fp32 (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
            + f"; sum {sum(parts.values()):.1f} | {card}")
        step_ms = {}
        for name in ("kernel", "plain"):
            ctx = plain_decode_attention() if name == "plain" else contextlib.nullcontext()
            with ctx:
                state = model.gpt.prefill(cond, text, lengths, max_new_tokens=120)
                state, _, _ = model.gpt.decode_chunk(state, None, chunk_size=20, top_k=1)
                sync(device)
                t1 = time.perf_counter()
                model.gpt.decode_chunk(state, None, chunk_size=100, top_k=1)
                sync(device)
                step_ms[name] = (time.perf_counter() - t1) * 1e3 / 100
        log(f"XTTS v1 decode step, fp32 GPT, B=1, cache {state['cur_index']}-"
            f"{state['cur_index'] + 100} keys: {step_ms['kernel']:.2f} ms kernel, "
            f"{step_ms['plain']:.2f} ms plain attention (host clock, synchronized) | {card}")
        launches_total = decode_attention.launches

        # the zoo's xtts_v1.1 from its directory, against the path load
        home = os.path.join(d, "home")
        zoo = os.path.join(home, "tts_tpu", XTTS_V1.replace("/", "--"))
        os.makedirs(zoo)
        with open(os.path.join(zoo, "config.json"), "w") as f:
            json.dump(model.config.to_dict(), f, default=str)
        shutil.copy(vocab, os.path.join(zoo, "vocab.json"))
        torch.save(model.state_dict_with_stats(), os.path.join(zoo, "model_torch.pt"))
        del model
        with offline_zoo(home):
            by_name = TTS(model_name=XTTS_V1, device=device)
            by_path = TTS(model_path=zoo, device=device)
            say = dict(speaker_wav=ref, language="en", max_new_tokens=20)
            with contextlib.redirect_stdout(sys.stderr):
                a = np.asarray(by_name.tts("hello there.", **say))
                b = np.asarray(by_path.tts("hello there.", **say))
        if a.shape != b.shape or float(np.abs(a - b).max()) != 0.0 or not np.isfinite(a).all():
            raise AssertionError("xtts_v1.1 by zoo name differs from the path load")
        log(f"xtts_v1.1 by zoo name (nothing fetched) equals the path load: {len(a)} samples")
        del by_name, by_path
    gc.collect()
    log(f"phase 17 (XTTS v1) took {time.time() - t_phase:.1f} s | {card}")
    return launches_total


# ---------------------------------------------------------------------------
TORTOISE = "tts_models/en/multi-dataset/tortoise-v2"
TORTOISE_CAP = 64  # codes a candidate: random weights never emit the stop token
TORTOISE_PROFILE_CAP = 8  # the profiled call's codes (16 gave ~43k kernels, ~10 s to digest)
TORTOISE_TOL = 1e-4  # card against CPU, as a share of each output's peak


def rlg_state(channels: int, seed: int) -> dict:
    """Random weights for a reference random latent generator (five
    EqualLinear layers, N(0, 1) as the reference draws them, then a Linear
    at 1 / fan-in)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    state = {}
    for i in range(6):
        scale = 1.0 if i < 5 else channels ** -0.5
        state[f"layers.{i}.weight"] = torch.randn(channels, channels, generator=gen) * scale
        state[f"layers.{i}.bias"] = torch.randn(channels, generator=gen) * 0.1
    return state


def peak_err(a, b) -> float:
    """Largest difference of ``a`` (card) and ``b`` (CPU) as a share of
    ``b``'s peak."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).abs().max() / b.abs().max())


def write_tortoise_dir(d: str, model, with_clvp: bool = True) -> None:
    """``model`` as the reference's tortoise-v2 directory."""
    import torch

    from tts_tpu_torch.utils import convert

    def save(state, name):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
                   os.path.join(d, name))

    os.makedirs(d, exist_ok=True)
    save(convert.reference_unified_voice_state(model.autoregressive.state_dict()),
         "autoregressive.pth")
    save(convert.reference_diffusion_state(model.diffusion.state_dict()), "diffusion_decoder.pth")
    if with_clvp:
        save(convert.reference_clvp_state(model.clvp.state_dict()), "clvp2.pth")
    voc = convert.reference_tortoise_univnet_state(model.vocoder.state_dict())["model_g"]
    torch.save({"model_g": {k: torch.from_numpy(v) for k, v in voc.items()}},
               os.path.join(d, "vocoder.pth"))
    torch.save(model.mel_norms.cpu(), os.path.join(d, "mel_norms.pth"))
    torch.save({k: v.cpu() for k, v in model.rlg_auto.items()}, os.path.join(d, "rlg_auto.pth"))
    torch.save({k: v.cpu() for k, v in model.rlg_diffuser.items()},
               os.path.join(d, "rlg_diffuser.pth"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f, default=list)


@contextlib.contextmanager
def stage_timer(model, device):
    """Milliseconds of each Tortoise stage inside (host clock,
    synchronized): the AR decode, the teacher-forced pass, CLVP, the
    diffusion (``timestep_independent`` and the sampler) and the vocoder."""
    from tts_tpu_torch.models.tortoise import model as tortoise

    ms = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    ar = model.autoregressive
    targets = [(ar, "generate", "AR decode"), (model, "rerank", "CLVP"),
               (model.diffusion, "timestep_independent", "diffusion"),
               (model, "vocode", "vocoder")]
    for obj, attr, name in targets:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    ar.forward = timed("teacher-forced", ar.forward)
    samplers = dict(tortoise.SAMPLERS)
    for key, fn in samplers.items():
        tortoise.SAMPLERS[key] = timed("diffusion", fn)
    try:
        yield ms
    finally:
        for obj, attr, _ in targets:
            delattr(obj, attr)
        del ar.forward
        tortoise.SAMPLERS.update(samplers)


def phase_tortoise(card: str, device="cuda", cut=None) -> int:
    """Tortoise at the default ``TortoiseArgs`` (AR 30 x 1024 x 16,
    diffusion 1024 x 10, CLVP 768 x 20 a side, UnivNet 32 channels), random
    fp32 weights from seed 0 (the UnivNet's predicted kernels scaled to 1 /
    fan-in, ``calibrate_univnet``), random latent generators and mel norms
    drawn here: card against CPU within 1e-4 of the peak on short inputs
    (the AR teacher-forced pass, 8 greedy decode steps, one guided diffusion
    step, CLVP's scores, the vocoder on a 20-frame mel); 16 sampled
    candidates' codes identical through K1 and through the plain attention
    on one generator, K1 launching 30 times a step; one whole
    ``synthesize`` from a voice folder and one from the random voice (16
    candidates capped at ``TORTOISE_CAP`` codes, 30 DDIM steps with
    classifier-free guidance), each with its stages and peak memory, the
    random one's busy share; ``tortoise-v2`` by zoo name against the path
    load; ``tts
    --voice_dir`` against the API. ``cut(config)`` shrinks the config in
    place for rehearsals on the CPU and may return smaller CLVP widths.
    Returns K1's launches on this path."""
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.audio.numpy_transforms import save_wav
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.tortoise import model as tortoise
    from tts_tpu_torch.models.tortoise.audio import format_conditioning
    from tts_tpu_torch.models.tortoise.config import TortoiseConfig
    from tts_tpu_torch.models.tortoise.layers import CLVP
    from tts_tpu_torch.ops.decode_attention import decode_attention

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    config = TortoiseConfig()
    clvp_kw = (cut or (lambda c: None))(config) or {}
    a = config.model_args
    with built_on(device):
        model = tortoise.Tortoise(config)
        model.clvp = CLVP(**clvp_kw)
    # built and drawn on the card (by init_params' rules, from a card
    # generator), then copied to the CPU: built and drawn on the CPU, these
    # 951 M weights took ~17 s
    model.init_params(seed=0, device=device, clvp=False)
    calibrate_univnet(model.vocoder)
    gen = torch.Generator().manual_seed(1)
    model.mel_norms = 1.0 + 0.1 * torch.rand(80, generator=gen)
    model.rlg_auto = rlg_state(a.ar_model_dim, 2)
    model.rlg_diffuser = rlg_state(2 * a.diff_model_channels, 3)
    cpu = copy.deepcopy(model).to("cpu")
    model.mel_norms = model.mel_norms.to(device)
    model.rlg_auto = {k: v.to(device) for k, v in model.rlg_auto.items()}
    model.rlg_diffuser = {k: v.to(device) for k, v in model.rlg_diffuser.items()}
    n_layers = len(model.autoregressive.gpt.h)
    counts = {name: sum(p.numel() for p in getattr(model, name).parameters()) / 1e6
              for name in ("autoregressive", "diffusion", "clvp", "vocoder")}
    log(f"Tortoise (TortoiseArgs() defaults, seed 0, fp32, TF32 off): "
        + ", ".join(f"{k} {v:.2f} M" for k, v in counts.items())
        + f" parameters; ready in {time.time() - t_phase:.1f} s")

    # short inputs, card against CPU
    rs = np.random.RandomState(0)
    wav22 = reference_wav(seconds=3.0, seed=3)
    inputs = dict(
        text=rs.randint(1, 250, (1, 20)), codes=rs.randint(0, 8192, (1, 30)),
        dlat=rs.randn(1, 2 * a.diff_model_channels).astype(np.float32) * 0.5,
        x=rs.randn(1, 86, a.diff_in_channels).astype(np.float32),
        cands=rs.randint(0, 8192, (4, 40)), mel=rs.randn(1, 20, 100).astype(np.float32) - 5,
        noise=rs.randn(1, 20, a.voc_noise_dim).astype(np.float32))
    outs = {}
    for m, dev in ((model, device), (cpu, "cpu")):
        x = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        with torch.no_grad():
            cond = m.autoregressive.get_conditioning(
                format_conditioning(wav22, m.mel_norms, device=dev))
            _, logits, latents = m.autoregressive(cond, x["text"], x["codes"])
            g = m.autoregressive.generate(cond.expand(2, -1, -1), x["text"].expand(2, -1), None,
                                          max_new_tokens=8, top_p=1e-6)
            emb = m.diffusion.timestep_independent(latents[:, :20], x["dlat"], 86)
            t = torch.full((1,), 3999, device=dev)
            eps = (1 + a.cond_free_k) * m.diffusion(x["x"], t, precomputed_embeddings=emb) \
                - a.cond_free_k * m.diffusion(x["x"], t, conditioning_free=True)
            scores = m.rerank(x["text"][0], x["cands"])
            wav = m.vocoder(x["mel"], x["noise"])
        outs[dev] = dict(cond=cond, logits=logits, latents=latents, codes=g["codes"],
                         dec_latents=g["latents"], emb=emb, eps=eps, scores=scores, wav=wav)
    card_out, cpu_out = outs[device], outs["cpu"]
    errs = {k: peak_err(card_out[k], cpu_out[k]) for k in
            ("cond", "logits", "latents", "dec_latents", "emb", "eps", "scores", "wav")}
    if not torch.equal(card_out["codes"].cpu(), cpu_out["codes"]):
        raise AssertionError("Tortoise greedy codes differ card against CPU")
    if not max(errs.values()) <= TORTOISE_TOL:
        raise AssertionError(f"Tortoise card against CPU: {errs}")
    log("Tortoise card against CPU on short inputs, as a share of each peak (tol 1e-4): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; 8 greedy decode steps of 2 rows identical (phase 18 at "
        f"{time.time() - t_phase:.1f} s) | " + card)
    del cpu, outs, card_out, cpu_out
    gc.collect()

    # K1 against the plain attention: 16 sampled candidates on one generator
    ids = torch.tensor([model.tokenizer.encode("Tortoise speaks through sixteen candidates.")
                        + [a.ar_stop_text_token]], device=device)
    cond = model.get_random_conditioning_latents(torch.Generator(device).manual_seed(0))[0]
    kw = dict(max_new_tokens=60, temperature=a.temperature, top_p=a.top_p,
              repetition_penalty=a.repetition_penalty)
    decode_attention.launches = 0
    steps = model.autoregressive.decode_steps
    with_kernel = model.autoregressive.generate(
        cond.expand(16, -1, -1), ids.expand(16, -1), torch.Generator(device).manual_seed(7), **kw)
    sync(device)
    launches = decode_attention.launches
    run_steps = model.autoregressive.decode_steps - steps
    if cuda and launches != n_layers * run_steps:
        raise AssertionError(f"Tortoise: {launches} K1 launches for {run_steps} steps")
    with plain_decode_attention():
        with_plain = model.autoregressive.generate(
            cond.expand(16, -1, -1), ids.expand(16, -1), torch.Generator(device).manual_seed(7),
            **kw)
    sync(device)
    if decode_attention.launches != launches:
        raise AssertionError("the plain run launched the kernel")
    if not torch.equal(with_kernel["codes"], with_plain["codes"]):
        raise AssertionError("Tortoise codes differ through K1 and the plain attention")
    L_pre = 1 + ids.shape[1] + 2 + 1
    log(f"Tortoise AR: 16 sampled candidates x {run_steps} steps (temperature {a.temperature}, "
        f"top_p {a.top_p}) identical through K1 and the plain attention on one generator; K1 "
        f"launched {launches} times = {n_layers} x {run_steps} steps at B=16, cache "
        f"{L_pre}-{L_pre + run_steps} keys | {card}")

    # whole synthesize calls from a voice folder and from the random voice
    launches_total = decode_attention.launches
    with tempfile.TemporaryDirectory() as d:
        voices = os.path.join(d, "voices")
        os.makedirs(os.path.join(voices, "emma"))
        for i, secs in enumerate((6.0, 4.0)):
            save_wav(wav=reference_wav(seconds=secs, seed=10 + i),
                     path=os.path.join(voices, "emma", f"{i}.wav"), sample_rate=22050)
        sentence = "The quick brown fox jumps over the lazy dog."
        for voice in ("emma", "random"):
            decode_attention.launches = 0
            steps = model.autoregressive.decode_steps
            with stage_timer(model, device) as ms:
                sync(device)
                t0 = time.perf_counter()
                out = model.synthesize(sentence, config, speaker_id=voice, voice_dirs=[voices],
                                       max_mel_tokens=TORTOISE_CAP)
                sync(device)
                wall = (time.perf_counter() - t0) * 1e3
            run_steps = model.autoregressive.decode_steps - steps
            if cuda and decode_attention.launches != n_layers * run_steps:
                raise AssertionError(f"synthesize: {decode_attention.launches} K1 launches for "
                                     f"{run_steps} steps")
            launches_total += decode_attention.launches
            w = out["wav"]
            if not np.isfinite(w).all() or w.std() == 0:
                raise AssertionError(f"Tortoise synthesize ({voice}) gave no finite audio")
            secs = len(w) / 24000
            log(f"Tortoise synthesize ({voice}; 16 candidates capped at {TORTOISE_CAP} codes, "
                f"{a.diffusion_iterations} DDIM steps with cond-free guidance): {secs:.2f} s of "
                f"audio in {wall:.1f} ms (RTF {secs * 1e3 / wall:.2f}); stages (ms) "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                + f"; {run_steps} decode steps, K1 {decode_attention.launches} launches | {card}")
            if cuda and voice == "random":
                # kernel rows only, one voice: ~150k kernels a call take the
                # profiler ~35 s to digest, CPU rows would add minutes
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    model.synthesize(sentence, config, speaker_id=voice, voice_dirs=[voices],
                                     max_mel_tokens=TORTOISE_PROFILE_CAP)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t1) * 1e6
                log_profile(prof, f"Tortoise synthesize ({voice}, {TORTOISE_PROFILE_CAP} codes)",
                            wall_us, card, top=5)
            log(f"  (phase 18 at {time.time() - t_phase:.1f} s)")

        # the zoo's tortoise-v2 (reference layout), the command line's --voice_dir;
        # its AR head emits the stop token first, so the surfaces' calls stop at
        # once where random weights would run all 500 codes (a depth cut)
        with torch.no_grad():
            model.autoregressive.mel_head.bias[config.model_args.ar_stop_mel_token] = 100.0
        home = os.path.join(d, "home")
        zoo = os.path.join(home, "tts_tpu", TORTOISE.replace("/", "--"))
        write_tortoise_dir(zoo, model, with_clvp=not clvp_kw)
        log(f"  (phase 18 at {time.time() - t_phase:.1f} s: the reference layout written)")
        with offline_zoo(home):
            by_name = TTS(model_name=TORTOISE, voice_dir=voices, device=device)
            log(f"  (phase 18 at {time.time() - t_phase:.1f} s: loaded by zoo name)")
            # the files hold the weights they were written from: the path load is
            # the model in memory
            loaded = by_name.synthesizer.tts_model
            if clvp_kw:  # a rehearsal's small CLVP is not in the directory
                model.clvp = None
            for name in [n for n in ("autoregressive", "diffusion", "clvp", "vocoder")
                         if getattr(model, n) is not None]:
                want = getattr(model, name).state_dict()
                got = getattr(loaded, name).state_dict()
                if set(got) != set(want) or any(not torch.equal(got[k], want[k]) for k in want):
                    raise AssertionError(f"tortoise-v2 by zoo name: the {name} weights differ")
            say = dict(speaker_id="emma", voice_dirs=[voices], max_mel_tokens=40,
                       num_autoregressive_samples=4, diffusion_iterations=5)
            x = loaded.synthesize("Hello there.", config, **say)["wav"]
            y = model.synthesize("Hello there.", config, **say)["wav"]
            if x.shape != y.shape or float(np.abs(x - y).max()) != 0.0:
                raise AssertionError("tortoise-v2 by zoo name differs from the path load")
            del model, loaded
            gc.collect()
            api, cli = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
            silent(by_name.tts_to_file, "Hello there.", speaker="emma", file_path=api)
            log(f"  (phase 18 at {time.time() - t_phase:.1f} s: TTS.tts_to_file)")
            silent(synthesize_cli, ["--text", "Hello there.", "--model_name", TORTOISE,
                                    "--voice_dir", voices, "--speaker_idx", "emma",
                                    "--out_path", cli, "--device", str(device)])
        steps_, sr = _int16_steps(cli, api)
        if steps_ is None or steps_ > 1 or sr != 24000:
            raise AssertionError(f"tts --voice_dir: {steps_} int16 steps from the API at {sr} Hz")
        log(f"tortoise-v2 by zoo name (nothing fetched) equals the path load ({len(x)} samples); "
            f"tts --model_name --voice_dir --speaker_idx emma within {steps_} int16 step of "
            f"TTS.tts_to_file at {sr} Hz (16 candidates stopping at their first code, "
            f"the directory's AR head set to emit the stop token)")
        del by_name
    gc.collect()
    line = f"phase 18 (Tortoise) took {time.time() - t_phase:.1f} s"
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f" | {card}")
    return launches_total


BARK = "tts_models/multilingual/multi-dataset/bark"
BARK_TOL = 1e-4  # card against CPU, as a share of each output's peak
BARK_TEXT = "Hello there."  # the surfaces' sentence: their semantic head stops at once for it
# both timed synthesize calls run a quarter of the default 8 s budget: a
# depth cut that keeps the script's time as phases 20 and 21 were added
BARK_BUDGET_S = 2.0
BARK_PROFILE_S = 0.25  # the profiled call's budget (0.5 s gave ~49k kernels, ~13 s to digest)
BARK_GPT = dict(n_layer=24, n_head=16, n_embd=1024)  # suno's large text, coarse and fine models


def bark_config():
    """The zoo's Bark at the published large models' widths (24 layers, 1024
    wide, 16 heads in all three GPTs), the text model's head 10,048 wide
    over its 129,600-token input (F48)."""
    from tts_tpu_torch.models.bark.config import BarkConfig, BarkGPTArgs

    return BarkConfig(
        semantic_config=BarkGPTArgs(input_vocab_size=129_600, output_vocab_size=10_048,
                                    **BARK_GPT),
        coarse_config=BarkGPTArgs(input_vocab_size=12_096, output_vocab_size=12_096, **BARK_GPT),
        fine_config=BarkGPTArgs(input_vocab_size=1056, output_vocab_size=1056, **BARK_GPT))


def write_bark_dir(d: str, model, with_encodec: bool = True) -> None:
    """``model`` as the reference's bark directory: ``text_2.pt``,
    ``coarse_2.pt`` and ``fine_2.pt`` as ``{"model": state, "model_args":
    ...}`` in nanoGPT's names, ``encodec_24khz.pth`` in HF ``EncodecModel``'s
    and ``config.json``."""
    import torch

    from tts_tpu_torch.utils import convert

    os.makedirs(d, exist_ok=True)
    for name, fname in (("semantic_model", "text_2.pt"), ("coarse_model", "coarse_2.pt"),
                        ("fine_model", "fine_2.pt")):
        gpt = getattr(model, name)
        state = convert.reference_bark_gpt_state(gpt.state_dict())
        torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()},
                    "model_args": gpt.args.to_dict()}, os.path.join(d, fname))
        del state
    if with_encodec:
        torch.save({k: torch.from_numpy(v) for k, v in
                    convert.reference_encodec_state(model.encodec.state_dict()).items()},
                   os.path.join(d, "encodec_24khz.pth"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(model.config.to_dict(), f, default=list)


def stop_at_first_token(model, text: str, histories=(None,)):
    """``model`` with its semantic head's EOS row set in the span of the last
    hidden states of ``text``'s prompts behind each of ``histories`` (a
    voice prompt's semantic tokens, or ``None`` for the random voice), so
    that EOS is the first token sampled for that text in those voices: its
    logit is 50 in each, the others' ~N(0, 1)."""
    import torch

    from tts_tpu_torch.models.bark.model import text_ids

    seen = []
    hook = model.semantic_model.core.register_forward_hook(
        lambda m, args, out: seen.append(out[0, -1]))
    with torch.no_grad():
        for history in histories:
            model.semantic_model(model.semantic_prompt(text_ids(text), history),
                                 merge_context=True)
        hook.remove()
        h = torch.stack(seen)  # [n, D]
        w = torch.linalg.pinv(h) @ torch.full((len(seen),), 50.0)
        model.semantic_model.lm_head.weight[model.config.SEMANTIC_VOCAB_SIZE] = w
    return model


@contextlib.contextmanager
def bark_stage_timer(model, device):
    """Milliseconds of each Bark stage inside (host clock, synchronized):
    semantic, coarse, fine and EnCodec."""
    ms = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    targets = (("generate_text_semantic", "semantic"), ("generate_coarse", "coarse"),
               ("generate_fine", "fine"), ("codes_to_audio", "EnCodec"))
    for attr, name in targets:
        setattr(model, attr, timed(name, getattr(model, attr)))
    try:
        yield ms
    finally:
        for attr, _ in targets:
            delattr(model, attr)


def bark_short_checks(model, device) -> dict:
    """The short inputs of phase 19 through ``model`` on ``device``: the
    semantic prefill's logits with ``merge_context``, 8 greedy decode steps
    (their logits and tokens), one coarse window (its prefill's logits
    under the window mask and 20 greedy tokens), one fine window's logits,
    EnCodec on 50 frames."""
    import torch

    from tts_tpu_torch.models.bark.model import text_ids

    c = model.config
    sem, coarse, fine = model.semantic_model, model.coarse_model, model.fine_model
    rs = np.random.RandomState(0)
    out = {}
    with torch.no_grad():
        prompt = model.semantic_prompt(text_ids("Bark checks its card against its CPU."))
        cache = sem.core.init_cache(1, 257 + 8, device=device)
        logits = sem(prompt, cache=cache, merge_context=True)
        out["semantic prefill"] = logits[0]
        last, steps, toks = logits[:, -1], [], []
        for s in range(8):
            tok = torch.argmax(last[:, : c.SEMANTIC_VOCAB_SIZE + 1], dim=-1)
            toks.append(tok)
            last = sem._decode(tok, cache, 257 + s)
            steps.append(last)
        out["semantic decode"] = torch.stack(steps, dim=1)[0]
        out["semantic tokens"] = torch.stack(toks, dim=1)[0]
        # one coarse window: 256 semantic tokens, the infer token, a tail of 300
        # valid coarse tokens padded to 630, 20 greedy steps
        semantic = torch.from_numpy(rs.randint(0, c.SEMANTIC_VOCAB_SIZE, (1, 256))).to(device)
        tail = torch.zeros(1, 630, dtype=torch.long, device=device)
        tail[0, :300] = torch.from_numpy(rs.randint(0, 2 * c.CODEBOOK_SIZE, 300)
                                         + c.SEMANTIC_VOCAB_SIZE)
        rows = torch.arange(887, device=device)
        mask = (rows[None] <= rows[:, None]) & (rows[None] < 557)
        win_prompt = torch.cat([semantic, torch.full((1, 1), c.COARSE_INFER_TOKEN, device=device),
                                tail], dim=1)
        ccache = coarse.core.init_cache(1, 887 + 20, device=device)
        out["coarse window prefill"] = coarse(win_prompt, cache=ccache, attn_mask=mask)[0, :557]
        buf = coarse.generate_coarse_windows(
            semantic, torch.zeros(1, 660, dtype=torch.long, device=device), [0], [0], [300],
            [300], None, window_steps=20, max_coarse_history=630,
            infer_token=c.COARSE_INFER_TOKEN, temperature=0.7, top_k=1, top_p=0.95,
            codebook_cycle=(c.SEMANTIC_VOCAB_SIZE, c.CODEBOOK_SIZE, c.N_COARSE_CODEBOOKS))
        out["coarse tokens"] = buf[0, 300:]
        idx = torch.from_numpy(rs.randint(0, c.CODEBOOK_SIZE, (1, 1024, 8))).to(device)
        out["fine window logits"] = fine(2, idx)[0]
        out["EnCodec 50 frames"] = model.encodec.decode(
            rs.randint(0, c.CODEBOOK_SIZE, (8, 50)))
    return out


def random_hubert_tokenizer(input_size: int, seed: int = 0):
    """The reference tokenizer's layout (2 LSTM layers 1024 wide, 10,000
    tokens) on the CPU, fp32 weights from ``seed``: N(0, 1/fan_in), biases 0."""
    import torch

    from tts_tpu_torch.models.bark.hubert import HubertTokenizer

    tok = HubertTokenizer(input_size=input_size)
    draw = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in tok.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=draw) / p[0].numel() ** 0.5)
    return tok.eval().requires_grad_(False)


def phase_bark(card: str, device="cuda", cut=None) -> int:
    """Bark at the zoo's widths (24 x 1024 x 16 in all three GPTs; the text
    model's head 10,048 wide, F48; EnCodec at the 24 kHz model's dims),
    random fp32 weights from seed 0: card against CPU within 1e-4 of the
    peak on short inputs (the semantic prefill with ``merge_context``, 8
    greedy decode steps, one coarse window, one fine window's logits,
    EnCodec on 50 frames); sampled semantic and coarse tokens identical
    through K1 and through the plain attention on one generator, K1
    launching 24 times a step; HuBERT-base and its tokenizer card against
    CPU on a 3 s clip, and ``generate_voice``'s prompt saved as
    ``voices/clone.npz``; one ``synthesize`` at random and one from that
    prompt, each at ``BARK_BUDGET_S``, with its stages, ms a decode step, K1's launches,
    busy share and top kernels and peak memory; the zoo's ``bark`` by name
    from a reference-layout directory (its semantic head set to stop at
    once for the surfaces' sentence) against the path load, ``tts
    --model_name --voice_dir --speaker_idx`` against ``TTS.tts_to_file``,
    one ``/api/tts`` request; last, Tortoise's wav2vec2 aligner at
    wav2vec2-large-robust's widths card against CPU on one clip. ``cut(config,
    hubert_cfg, wav2vec_cfg)`` shrinks the configs in place for rehearsals
    on the CPU. Returns K1's launches on this path."""
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.audio.numpy_transforms import save_wav
    from tts_tpu_torch.bin.synthesize import main as synthesize_cli
    from tts_tpu_torch.models.bark import hubert
    from tts_tpu_torch.models.bark.model import Bark
    from tts_tpu_torch.models.tortoise import wav2vec_alignment as w2v
    from tts_tpu_torch.ops.decode_attention import decode_attention

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()

    def silent(fn, *args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    def stamp(what: str) -> None:
        log(f"  (phase 19 at {time.time() - t_phase:.1f} s: {what})")

    config = bark_config()
    hubert_cfg, w2v_cfg = hubert.hubert_base_config(), w2v.wav2vec2_large_robust_config()
    if cut is not None:
        cut(config, hubert_cfg, w2v_cfg)
    # built and drawn on the card (by init_params' rules, from a card
    # generator), then copied to the CPU: built and drawn on the CPU, these
    # 1.1 B weights took ~19 s
    with built_on(device):
        model = Bark(config)
    model.init_params(seed=0, device=device)
    cpu = copy.deepcopy(model).to("cpu")
    n_layers = config.semantic_config.n_layer
    counts = {name: sum(p.numel() for p in getattr(cpu, name).parameters()) / 1e6
              for name in ("semantic_model", "coarse_model", "fine_model", "encodec")}
    log(f"Bark ({n_layers} x {config.semantic_config.n_embd} x {config.semantic_config.n_head} "
        "in all three GPTs, the text head 10,048 wide; seed 0, fp32, TF32 off): "
        + ", ".join(f"{k} {v:.2f} M" for k, v in counts.items())
        + f" parameters; ready in {time.time() - t_phase:.1f} s")

    # short inputs, card against CPU
    card_out, cpu_out = bark_short_checks(model, device), bark_short_checks(cpu, "cpu")
    errs = {}
    for k, want in cpu_out.items():
        if "tokens" in k:
            if not torch.equal(card_out[k].cpu(), want):
                raise AssertionError(f"Bark {k} differ card against CPU")
        else:
            errs[k] = peak_err(card_out[k], want)
    if not max(errs.values()) <= BARK_TOL:
        raise AssertionError(f"Bark card against CPU: {errs}")
    log("Bark card against CPU on short inputs, as a share of each peak (tol 1e-4): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + "; 8 greedy semantic tokens and 20 greedy coarse tokens identical | " + card)
    del card_out, cpu_out
    stamp("short inputs")

    # K1 against the plain attention: sampled tokens on one generator
    text = "Bark samples through the kernel and through the plain attention."
    kw = dict(max_gen_duration_s=1.0)
    runs = {}
    for name, ctx in (("K1", contextlib.nullcontext), ("plain", plain_decode_attention)):
        decode_attention.launches = 0
        steps0 = model.semantic_model.decode_steps + model.coarse_model.decode_steps
        gen = torch.Generator(device).manual_seed(7)
        with ctx():
            semantic = model.generate_text_semantic(
                np.frombuffer(text.encode(), np.uint8).astype(np.int64), gen, **kw)
            coarse = model.generate_coarse(semantic[:40], gen)
        sync(device)
        steps = model.semantic_model.decode_steps + model.coarse_model.decode_steps - steps0
        runs[name] = (semantic, coarse, decode_attention.launches, steps)
    (s1, c1, launches, steps), (s2, c2, plain_launches, _) = runs["K1"], runs["plain"]
    if not (np.array_equal(s1, s2) and np.array_equal(c1, c2)):
        raise AssertionError("Bark tokens differ through K1 and the plain attention")
    if cuda and (launches != n_layers * steps or plain_launches != 0):
        raise AssertionError(f"Bark: {launches} K1 launches for {steps} steps "
                             f"({plain_launches} in the plain run)")
    log(f"Bark: {len(s1)} sampled semantic tokens and {c1.size} coarse tokens (temperature 0.7, "
        f"top_k 50, top_p 0.95) identical through K1 and the plain attention on one generator; "
        f"K1 launched {launches} times = {n_layers} x {steps} steps at B=1 | {card}")
    launches_total = launches

    with tempfile.TemporaryDirectory() as d:
        # voice prompts: HuBERT-base and its tokenizer card against CPU on a 3 s clip
        voices = os.path.join(d, "voices")
        os.makedirs(voices)
        hub_cpu = random_wavlm(hubert_cfg, seed=3)
        tok_cpu = random_hubert_tokenizer(hubert_cfg.encoder_embed_dim, seed=4)
        hub_card = copy.deepcopy(hub_cpu).to(device)
        tok_card = copy.deepcopy(tok_cpu).to(device)
        clip16 = reference_wav(seconds=3.0, sr=16000, seed=21)
        with torch.no_grad():
            feats = [h(torch.from_numpy(clip16)[None].to(dev), output_layer=9)
                     for h, dev in ((hub_card, device), (hub_cpu, "cpu"))]
        ids = [hubert.semantic_tokens_from_audio(clip16, h, t)
               for h, t in ((hub_card, tok_card), (hub_cpu, tok_cpu))]
        feat_err = peak_err(feats[0], feats[1])
        if not (feat_err <= BARK_TOL and np.array_equal(ids[0], ids[1])):
            raise AssertionError(f"HuBERT card against CPU: features {feat_err}, ids "
                                 f"{int((ids[0] != ids[1]).sum())} differ")
        clip24 = reference_wav(seconds=3.0, sr=24000, seed=21)
        sync(device)
        t0 = time.perf_counter()
        prompt = model.generate_voice(clip24, hub_card, tok_card,
                                      output_path=os.path.join(voices, "clone.npz"),
                                      sample_rate=24000)
        sync(device)
        voice_ms = (time.perf_counter() - t0) * 1e3
        log(f"Bark voice prompt: HuBERT-base layer-9 features card against CPU "
            f"{feat_err:.3g} of their peak, {len(ids[0])} tokenizer ids identical on a 3 s clip; "
            f"generate_voice {voice_ms:.1f} ms: semantic {prompt['semantic_prompt'].shape}, "
            f"coarse {prompt['coarse_prompt'].shape}, fine {prompt['fine_prompt'].shape} | {card}")
        del hub_cpu, tok_cpu, hub_card, tok_card, feats
        stamp("voice prompt")

        # synthesize calls at BARK_BUDGET_S, at random and from the voice
        # prompt; then a short random one under the profiler (a whole 8 s
        # call launches ~520k kernels, which the profiler takes ~2 min to
        # digest)
        sentence = "The quick brown fox jumps over the lazy dog."
        for voice in ("random", "clone"):
            decode_attention.launches = 0
            steps0 = model.semantic_model.decode_steps + model.coarse_model.decode_steps
            budget = {"max_gen_duration_s": BARK_BUDGET_S}
            with bark_stage_timer(model, device) as ms:
                sync(device)
                t0 = time.perf_counter()
                out = model.synthesize(sentence, config, speaker_id=voice, voice_dirs=[voices],
                                       **budget)
                sync(device)
                wall = (time.perf_counter() - t0) * 1e3
            steps = model.semantic_model.decode_steps + model.coarse_model.decode_steps - steps0
            if cuda and decode_attention.launches != n_layers * steps:
                raise AssertionError(f"synthesize: {decode_attention.launches} K1 launches for "
                                     f"{steps} steps")
            launches_total += decode_attention.launches
            w = out["wav"]
            if not np.isfinite(w).all() or w.std() == 0:
                raise AssertionError(f"Bark synthesize ({voice}) gave no finite audio")
            if out["fine"].min() < 0 or out["fine"].max() >= config.CODEBOOK_SIZE:
                raise AssertionError("Bark fine codes outside the codebook")
            secs = len(w) / config.SAMPLE_RATE
            per_step = (ms["semantic"] + ms["coarse"]) / max(steps, 1)
            log(f"Bark synthesize ({voice}): {len(out['semantic'])} semantic tokens, "
                f"{out['coarse'].shape[1]} coarse and fine frames, {secs:.2f} s of audio in "
                f"{wall:.1f} ms (RTF {secs * 1e3 / wall:.3f}); stages (ms) "
                + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
                + f"; {steps} decode steps, {per_step:.2f} ms a step (semantic and coarse), "
                f"K1 {decode_attention.launches} launches | {card}")
            if cuda and voice == "random":  # one voice: ~25k kernels a profile
                decode_attention.launches = 0
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    short = model.synthesize(sentence, config, speaker_id=voice,
                                             voice_dirs=[voices],
                                             max_gen_duration_s=BARK_PROFILE_S)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t1) * 1e6
                launches_total += decode_attention.launches
                log_profile(prof, f"Bark synthesize ({voice}) at a {BARK_PROFILE_S} s budget "
                            f"({len(short['semantic'])} semantic tokens, "
                            f"{short['coarse'].shape[1]} frames)", wall_us, card, top=5)
                log(f"  peak device memory so far {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
                    f"allocated | {card}")
            stamp(f"synthesize ({voice})")
        del model
        gc.collect()

        # the zoo's bark (reference layout), the command line, the server
        stop_at_first_token(cpu, BARK_TEXT, (None, prompt["semantic_prompt"]))
        home = os.path.join(d, "home")
        zoo = os.path.join(home, "tts_tpu", BARK.replace("/", "--"))
        write_bark_dir(zoo, cpu)
        written = {name: getattr(cpu, name).state_dict()
                   for name in ("semantic_model", "coarse_model", "fine_model", "encodec")}
        del cpu
        stamp("the reference layout written")
        with offline_zoo(home):
            by_path = TTS(model_path=zoo, voice_dir=voices, device=device)
            loaded = by_path.synthesizer.tts_model
            for name, want in written.items():
                got = getattr(loaded, name).state_dict()
                if set(got) != set(want) or any(not torch.equal(got[k].cpu(), want[k])
                                                for k in want):
                    raise AssertionError(f"bark by path: the {name} weights differ")
            del written
            stamp("loaded by path")
            x = silent(by_path.tts, BARK_TEXT, speaker="clone")
            if len(x) != 320 + 10000:  # one frame, then the sentence's gap
                raise AssertionError(f"the stopping head did not stop: {len(x)} samples")
            del by_path, loaded
            gc.collect()
            by_name = TTS(model_name=BARK, voice_dir=voices, device=device)
            stamp("loaded by zoo name")
            y = silent(by_name.tts, BARK_TEXT, speaker="clone")
            if len(x) != len(y) or float(np.abs(np.asarray(x) - np.asarray(y)).max()) != 0.0:
                raise AssertionError("bark by zoo name differs from the path load")
            api, cli = os.path.join(d, "api.wav"), os.path.join(d, "cli.wav")
            silent(by_name.tts_to_file, BARK_TEXT, speaker="clone", file_path=api)
            del by_name
            gc.collect()
            silent(synthesize_cli, ["--text", BARK_TEXT, "--model_name", BARK, "--voice_dir",
                                    voices, "--speaker_idx", "clone", "--out_path", cli,
                                    "--device", str(device)])
            stamp("tts --model_name --voice_dir --speaker_idx")
            status, body, said, _ = _serve_once(["--model_name", BARK], {"text": BARK_TEXT},
                                                device)
        steps_, sr = _int16_steps(cli, api)
        if steps_ is None or steps_ > 1 or sr != 24000:
            raise AssertionError(f"tts --voice_dir: {steps_} int16 steps from the API at {sr} Hz")
        import scipy.io.wavfile

        rate, pcm = scipy.io.wavfile.read(io.BytesIO(body))
        if status != 200 or rate != 24000 or not len(pcm) or "serially" not in said:
            raise AssertionError(f"/api/tts on bark: status {status}, {rate} Hz, {len(pcm)} "
                                 f"samples; the server said {said!r}")
        log(f"bark by zoo name (nothing fetched) equals the path load ({len(x)} samples of the "
            f"stopping sentence in the cloned voice); tts --model_name --voice_dir --speaker_idx "
            f"within {steps_} int16 step of TTS.tts_to_file at {sr} Hz; /api/tts answered "
            f"{len(pcm)} samples at {rate} Hz, serially")
        stamp("server")

    # Tortoise's wav2vec2 aligner, card against CPU on one clip
    ctc_cpu = w2v.Wav2Vec2CTC(w2v_cfg, vocab_size=40)
    ctc_cpu.wav2vec2 = random_wavlm(w2v_cfg, seed=5)
    with torch.no_grad():
        ctc_cpu.lm_head.weight.copy_(torch.randn(40, w2v_cfg.encoder_embed_dim,
                                                 generator=torch.Generator().manual_seed(6))
                                     / w2v_cfg.encoder_embed_dim ** 0.5)
        ctc_cpu.lm_head.bias.zero_()
    ctc_cpu.eval().requires_grad_(False)
    ctc_card = copy.deepcopy(ctc_cpu).to(device)
    vocab = {c: i for i, c in enumerate("~abcdefghijklmnopqrstuvwxyz .,!?'-;:\"()")}
    clip = reference_wav(seconds=3.0, sr=24000, seed=31)
    x16 = torch.from_numpy(np.random.RandomState(1).randn(1, 48000).astype(np.float32))
    with torch.no_grad():
        lg = [m(x16.to(dev)) for m, dev in ((ctc_card, device), (ctc_cpu, "cpu"))]
    ctc_err = peak_err(lg[0], lg[1])
    aligners = [w2v.Wav2VecAlignment(m, vocab) for m in (ctc_card, ctc_cpu)]
    frame_ids = [a._ctc_frame_ids(clip, 24000) for a in aligners]
    heard = aligners[1]._decode(frame_ids[1].tolist())
    words = "".join(ch for ch in heard if ch in vocab)[:8] or "a"
    offsets = [a.align(clip, words, 24000) for a in aligners]
    if not (ctc_err <= BARK_TOL and np.array_equal(frame_ids[0], frame_ids[1])
            and offsets[0] == offsets[1]):
        raise AssertionError(f"wav2vec2 aligner card against CPU: logits {ctc_err}, "
                             f"frame ids equal {np.array_equal(*frame_ids)}")
    log(f"wav2vec2 aligner ({w2v_cfg.encoder_layers} x {w2v_cfg.encoder_embed_dim}, random): "
        f"CTC logits card against CPU {ctc_err:.3g} of their peak on 3 s; {len(frame_ids[0])} "
        f"frame ids and the offsets of {len(words)} characters identical | {card}")
    del ctc_cpu, ctc_card
    gc.collect()
    line = f"phase 19 (Bark) took {time.time() - t_phase:.1f} s"
    if cuda:
        peak = torch.cuda.max_memory_allocated()
        line += (f"; peak device memory {peak / 1e9:.3f} GB allocated, "
                 f"{(peak - resident) / 1e9:.3f} GB above the {resident / 1e9:.3f} GB resident")
    log(line + f" | {card}")
    return launches_total


# ---------------------------------------------------------------------------
# phase 20: int8 weight-only serving through K4
# ---------------------------------------------------------------------------

INT8_TOL = {"fp32": 1e-5, "bf16": 2 ** -7}  # K4 against its plain version, share of the peak
INT8_MODEL_TOL = 1e-4  # card against CPU, the int8 XTTS's outputs, share of each peak
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
INT8_CHECK_SHAPES = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024), (1024, 1026),
                     (1024, 8194), (1024, 10_048))  # (K, N): the layers and the heads
INT8_CHECK_ROWS = (1, 4, 16, 513, 1024)
INT8_LAYERS = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))  # c_attn, c_proj, fc, proj
# timed in both types (the decode steps' layers and heads at M 1, 4 and 16, the
# 513-row prompt, Bark's 887-row coarse prompt, a fine window's head); the
# shapes the served paths launch are recorded as they run and timed in
# their own type; Bark's fine windows (1024 rows, fp32), which phase 20's
# Bark run stops short of, are added
INT8_TIMED = [(M, K, N) for M in (1, 4, 16) for K, N in
              ((1024, 3072), (4096, 1024), (1024, 1026), (1024, 8194), (1024, 10_048))] \
    + [(513, 1024, 3072), (887, 1024, 3072), (1024, 1024, 1056)]
INT8_BARK_TIMED = [(1024, K, N) for K, N in INT8_LAYERS]
INT8_VARIANT_ROWS = (1, 2, 4, 8, 16)  # each kernel forced at these M, old against new
INT8_STEPS = 20  # decode steps a timing of the int8 and float XTTS steps


def int8_bound_ms(M: int, K: int, N: int, dtype, bias: bool) -> tuple:
    """Least time for one K4 call: the int8 weights, the fp32 scales, the
    activations (and bias) read once and the output written once over the
    memory rate, or ``2 M N K`` operations at the bf16 tensor-core peak, for
    either type: K4 runs fp32 activations through the tensor cores as three
    exact bf16 parts (3x these operations), so no share can read over 100 %.
    Returns ``(ms, "bytes" or "operations", bytes)``."""
    import torch

    elt = torch.finfo(dtype).bits // 8
    nbytes = N * K + 4 * N + M * K * elt + M * N * elt + (N * elt if bias else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * M * N * K / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes)


@contextlib.contextmanager
def plain_int8_linear():
    """The int8 modules call K4's plain PyTorch version instead of the
    kernel, for one comparison only."""
    from tts_tpu_torch.ops import quant

    forward = quant.Int8Linear.forward
    quant.Int8Linear.forward = lambda self, x: quant.int8_linear_torch(
        x, self.weight_int8, self.scale, self.bias)
    try:
        yield
    finally:
        quant.Int8Linear.forward = forward


@contextlib.contextmanager
def recorded_int8_shapes(shapes: dict):
    """Count the ``(M, K, N, type)`` of each int8 module call into
    ``shapes``, for one run only (the recording costs host time)."""
    from tts_tpu_torch.ops import quant

    forward = quant.Int8Linear.forward

    def recording(self, x):
        key = (x.numel() // x.shape[-1], self.in_features, self.out_features, str(x.dtype)[6:])
        shapes[key] = shapes.get(key, 0) + 1
        return forward(self, x)

    quant.Int8Linear.forward = recording
    try:
        yield
    finally:
        quant.Int8Linear.forward = forward


def int8_library_call(x, q, scale):
    """The library yardstick the port never calls: ``torch._weight_int8pack_mm``
    where this PyTorch runs it on the card, else dequantize + ``F.linear``
    (two calls). Returns ``(fn, label)``."""
    import torch
    import torch.nn.functional as F

    s = scale.to(x.dtype)
    try:
        torch._weight_int8pack_mm(x, q, s)
        torch.cuda.synchronize()
        return (lambda: torch._weight_int8pack_mm(x, q, s)), "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError):
        return (lambda: F.linear(x, q.to(x.dtype) * s[:, None])), "dequantize + F.linear"


def int8_sass_counts(path) -> dict:
    """Tensor-core (HMMA, HGMMA) and fp32 FMA instructions of each K4 kernel
    in the built library's SASS (``cuobjdump -sass``), summed over its
    instances: ``{kernel: {op: count}}``."""
    from tts_tpu_torch.ops.cuda_build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = next((k for k in ("k4_gemv", "k4_skinny", "k4_tile") if k in line), None)
            counts.setdefault(kernel, {})
        elif kernel:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[kernel][op] = counts[kernel].get(op, 0) + 1
    counts.pop(None, None)
    return counts


def int8_timings(M: int, K: int, N: int, dtype, gen, card: str) -> dict:
    """K4 at one shape: device time (CUDA graph replays over 32 weight copies
    at M <= 16, more bytes than the L2 holds, so each call reads its weights
    from device memory; 2 copies above), its bound, the plain version, the
    library yardstick and ``F.linear`` on a float weight of x's type; host
    time a call with its launch (back-to-back calls between CUDA events) of
    the served module, of the public function and of ``F.linear``."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    from tts_tpu_torch.ops.quant import Int8Linear, int8_linear, int8_linear_torch, quantize_int8

    dev = torch.device("cuda")
    copies = 32 if M <= 16 else 2
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    ws = [quantize_int8(torch.randn(N, K, generator=gen, device=dev) / K ** 0.5)
          for _ in range(copies)]
    floats = [(q.to(dtype) * s[:, None].to(dtype)) for q, s in ws[:min(copies, 8)]]
    kern = [lambda q=q, s=s: int8_linear(x, q, s) for q, s in ws]
    plain = [lambda q=q, s=s: int8_linear_torch(x, q, s) for q, s in ws]
    libs = [int8_library_call(x, q, s) for q, s in ws]
    lin = [lambda w=w: F.linear(x, w) for w in floats]
    with torch.device(dev):
        module = Int8Linear(nn.Linear(K, N, bias=False)).to(dtype)
    slow = M > 16  # the library yardstick takes milliseconds there
    t = {"kernel": time_device(kern), "plain": time_device(plain, rounds=2),
         "library": time_device([fn for fn, _ in libs], rounds=1, replays=2 if slow else 10),
         "linear": time_device(lin, rounds=4)}
    t["kernel2"] = time_device(kern, rounds=3)
    t["module_call"] = time_host(lambda: module(x), iters=30, warmup=5)
    t["kernel_call"] = time_host(kern[0], iters=30, warmup=5)
    t["linear_call"] = time_host(lin[0], iters=30, warmup=5)
    bound, bound_by, nbytes = int8_bound_ms(M, K, N, dtype, bias=False)
    t.update(bound=bound, bound_by=bound_by, bytes=nbytes, library_label=libs[0][1])
    log(f"int8_linear {str(dtype)[6:]} M={M} K={K} N={N}: device "
        f"{t['kernel'] * 1e3:.2f} / {t['kernel2'] * 1e3:.2f} us kernel, "
        f"{t['plain'] * 1e3:.2f} us plain, {t['library'] * 1e3:.2f} us library "
        f"({libs[0][1]}), {t['linear'] * 1e3:.2f} us F.linear on a {str(dtype)[6:]} weight; "
        f"bound {bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB, {bound_by}): "
        f"{100 * bound / t['kernel']:.1f} % of bound; per call with launch "
        f"{t['module_call'] * 1e3:.2f} us module, {t['kernel_call'] * 1e3:.2f} us function, "
        f"{t['linear_call'] * 1e3:.2f} us F.linear | {card}")
    return t


def int8_variant_timings(card: str) -> None:
    """Each of K4's kernels forced at the small M (graph replays over 32
    weight copies): the CUDA-core k4_gemv (the only small-M kernel before the
    tensor-core ones)
    against the tensor-core k4_skinny and k4_tile, in one run."""
    import torch

    from tts_tpu_torch.ops.quant import int8_linear, quantize_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    for K, N in ((1024, 3072), (4096, 1024)):
        ws = [quantize_int8(torch.randn(N, K, generator=gen, device=dev) / K ** 0.5)
              for _ in range(32)]
        for dtype in (torch.bfloat16, torch.float32):
            for M in INT8_VARIANT_ROWS:
                x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                us = {v: time_device([lambda q=q, s=s: int8_linear(x, q, s, variant=v)
                                      for q, s in ws], rounds=3) * 1e3
                      for v in ("gemv", "skinny", "tile")}
                log(f"int8_linear variants {str(dtype)[6:]} M={M} K={K} N={N}: device us "
                    + ", ".join(f"{v} {u:.2f}" for v, u in us.items()) + f" | {card}")
        del ws


def int8_host_costs(card: str, calls: int = 400) -> None:
    """Host µs a call (``time.perf_counter`` over back-to-back calls, no
    synchronisation inside; the device work of one call is shorter) of a
    bf16 decode step's c_attn (x ``[1, 1, 1024]``, 1024 -> 3072): the
    served module, the public function with bare tensors, ``F.linear`` on
    the bf16 weight, and the pieces of the module's call."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    from tts_tpu_torch.ops import quant

    dev = torch.device("cuda")
    with torch.device(dev):
        lin = nn.Linear(1024, 3072).to(torch.bfloat16)
    x = torch.randn(1, 1, 1024, device=dev, dtype=torch.bfloat16)
    w = lin.weight.detach().clone()
    module = quant.Int8Linear(lin)
    q, s, b = module.weight_int8, module.scale, module.bias
    built, _ = quant._kernel()
    shape = x.shape[:-1] + (3072,)
    pieces = {
        "module call": lambda: module(x),
        "public int8_linear (every check, a descriptor a call)":
            lambda: quant.int8_linear(x, q, s, b),
        "F.linear (bf16 weight, bias)": lambda: F.linear(x, w, lin.bias),
        "  torch.empty of the output": lambda: torch.empty(shape, dtype=x.dtype, device=dev),
        "  the current stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "  a ctypes call, no arguments": lambda: built.lib.tts_int8_linear_desc_bytes(),
        "  x.is_contiguous() + data_ptr()": lambda: (x.is_contiguous(), x.data_ptr()),
        "  the launch count": quant.int8_linear.count,
    }
    us = {}
    for name, fn in pieces.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us[name] = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
    quant.int8_linear.launches = 0
    log("int8_linear host µs a call (perf_counter, no sync inside; 1 x 1024 -> 3072 bf16): "
        + "; ".join(f"{n.strip()} {u:.2f}" for n, u in us.items()) + f" | {card}")


def phase_int8_kernel(card: str) -> tuple:
    """K4 against its plain version at the serving path's shapes (repeated
    calls bit-identical), each kernel forced at the small M, its SASS's
    tensor-core instructions, then timed beside its bound, the plain
    version, the library yardstick and ``F.linear``; old and new kernels at
    the small M. Returns K4's entry of the kernels line and the timings by
    ``(M, K, N, type)``."""
    import torch

    from tts_tpu_torch.ops.cuda_build import load_library
    from tts_tpu_torch.ops.quant import int8_linear, int8_linear_torch, quantize_int8

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    worst = {"fp32": 0.0, "bf16": 0.0}
    worst_abs = 0.0
    n_checks = 0

    def operands(M, K, N, dtype, bias=True):
        w = torch.randn(N, K, generator=gen, device=dev) / K ** 0.5
        q, s = quantize_int8(w)
        b = torch.randn(N, generator=gen, device=dev).to(dtype) if bias else None
        return torch.randn(M, K, generator=gen, device=dev).to(dtype), q, s, b

    def check(M, K, N, dtype, bias, variant="auto"):
        nonlocal n_checks, worst_abs
        x, q, s, b = operands(M, K, N, dtype, bias)
        got, again = int8_linear(x, q, s, b, variant), int8_linear(x, q, s, b, variant)
        want = int8_linear_torch(x, q, s, b)
        torch.cuda.synchronize()
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        abs_err = (got.float() - want.float()).abs().max().item()
        err = abs_err / want.float().abs().max().item()
        worst[kind], worst_abs = max(worst[kind], err), max(worst_abs, abs_err)
        n_checks += 1
        if not err <= INT8_TOL[kind]:
            raise AssertionError(f"int8_linear M={M} K={K} N={N} {kind} {variant}: {err:.3g} of "
                                 f"the peak > {INT8_TOL[kind]}")
        if not torch.equal(got, again):
            raise AssertionError(f"int8_linear M={M} K={K} N={N} {kind} {variant}: two calls "
                                 f"differ")

    for K, N in INT8_CHECK_SHAPES:
        for M in INT8_CHECK_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                check(M, K, N, dtype, bias=N != 10_048)  # Bark's heads have no bias
    # the conditioning encoders' and the perceiver's K (no multiple of 16)
    for M, K, N in ((300, 80, 1024), (3, 80, 1024), (32, 2730, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            check(M, K, N, dtype, bias=True)
    n_auto = n_checks
    for variant in ("gemv", "skinny", "tile"):
        for M in INT8_VARIANT_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                check(M, 1024, 1026, dtype, bias=True, variant=variant)
    log(f"int8_linear (K4): {n_auto} cases agree with the plain version, and {n_checks - n_auto} "
        f"with each kernel forced (gemv, skinny, tile at M {INT8_VARIANT_ROWS}), each called "
        f"twice with bit-identical results; largest difference as a share of the output's "
        f"peak: fp32 {worst['fp32']:.3g} (tol {INT8_TOL['fp32']:g}: summation order), bf16 "
        f"{worst['bf16']:.3g} (tol 2^-7: one bf16 rounding of fp32 sums that differ in their "
        f"last bits); largest absolute difference {worst_abs:.3g}")

    sass = int8_sass_counts(load_library("int8_linear").path)
    log("int8_linear SASS (cuobjdump -sass of the built library, all instances of each "
        "kernel): " + "; ".join(f"{k} " + ", ".join(f"{op} {n}" for op, n in sorted(c.items()))
                                for k, c in sorted(sass.items())))
    if not all(sass.get(k, {}).get("HMMA", 0) > 0 for k in ("k4_skinny", "k4_tile")):
        raise AssertionError(f"int8_linear: no tensor-core instruction in k4_skinny or k4_tile: "
                             f"{sass}")

    log(f"int8_linear bounds: bytes at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, or 2 M N K operations "
        f"at the bf16 tensor-core peak ({BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s) for fp32 too "
        f"(K4's fp32 runs three exact bf16 parts through the tensor cores)")
    times = {}
    for M, K, N in INT8_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            times[(M, K, N, str(dtype)[6:])] = int8_timings(M, K, N, dtype, gen, card)
    for M, K, N in INT8_BARK_TIMED:
        times[(M, K, N, "float32")] = int8_timings(M, K, N, torch.float32, gen, card)
    int8_variant_timings(card)
    int8_host_costs(card)
    t = times[(1, 1024, 3072, "bfloat16")]
    kernel = {
        "name": "int8_linear",
        "route": "cuda",
        "source": "tts_tpu_torch/csrc/int8_linear.cu",
        "replaces": "tts_tpu/ops/quant.py:56",
        "max_abs_err": worst_abs,
        "ms": t["kernel"],
        "plain_ms": t["plain"],
        "bound_ms": t["bound"],
        "bound_by": t["bound_by"],
        "library_ms": t["library"],
    }
    return kernel, times


def int8_served_timings(shapes: dict, times: dict, card: str) -> None:
    """Time the recorded served shapes not timed yet, then print one row a
    served shape (calls in the recorded runs beside it) for PERF.md."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(22)
    for (M, K, N, kind) in sorted(shapes):
        if (M, K, N, kind) not in times:
            times[(M, K, N, kind)] = int8_timings(M, K, N, getattr(torch, kind), gen, card)
    log("int8_linear served shapes (M K N type: calls recorded | device us K4, bound (by), "
        "share, plain, library, F.linear | host us with launch module, function, F.linear):")
    for key in sorted(shapes):
        t = times[key]
        log(f"  {key[0]} {key[1]} {key[2]} {key[3]}: {shapes[key]} | {t['kernel'] * 1e3:.2f}, "
            f"{t['bound'] * 1e3:.2f} ({t['bound_by']}), {100 * t['bound'] / t['kernel']:.1f} %, "
            f"{t['plain'] * 1e3:.2f}, {t['library'] * 1e3:.2f}, {t['linear'] * 1e3:.2f} | "
            f"{t['module_call'] * 1e3:.2f}, {t['kernel_call'] * 1e3:.2f}, "
            f"{t['linear_call'] * 1e3:.2f} | {card}")


def draw_on_device(module, seed: int, device):
    """Random weights drawn where ``module`` lies (fast at a billion
    parameters): norm scales 1, biases 0, linear and conv weights
    N(0, 1/fan_in), everything else N(0, 0.02²)."""
    import torch
    import torch.nn as nn

    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            for name, p in m.named_parameters(recurse=False):
                if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                    p.fill_(1.0 if name == "weight" else 0.0)
                elif name.startswith("bias"):
                    p.zero_()
                elif isinstance(m, (nn.Linear, nn.Conv1d)):
                    p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
                else:
                    p.normal_(0.0, 0.02, generator=gen)
    return module.requires_grad_(False)


def allocated(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def bf16_step_ms(gpt, cond, tokens, lens, B: int, device) -> tuple:
    """ms a decode step (host clock, synchronized) over ``INT8_STEPS`` steps
    after a prefill and a 10-step chunk, with the K4 and K1 launches of the
    timed steps."""
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.ops.quant import int8_linear

    state = gpt.prefill(cond.expand(B, -1, -1), tokens.expand(B, -1), lens.expand(B),
                        max_new_tokens=120)
    state, _, _ = gpt.decode_chunk(state, None, chunk_size=10, top_k=1)
    sync(device)
    int8_linear.launches = decode_attention.launches = 0
    t1 = time.perf_counter()
    gpt.decode_chunk(state, None, chunk_size=INT8_STEPS, top_k=1)
    sync(device)
    return ((time.perf_counter() - t1) * 1e3 / INT8_STEPS, int8_linear.launches,
            decode_attention.launches, state["cur_index"])


def int8_xtts(card: str, device, config=None, shapes=None) -> dict:
    """XTTS v2 with ``gpt_int8_weights``: card against CPU (conditioning,
    prefill, 8 greedy steps), K4 against the plain version on the card,
    launches a step; then from a model directory whose ``config.json``
    carries the flag, through ``TTS``: resident bytes, ms a bf16 decode step
    at B=1 and B=4 beside the float model's from the same directory (in
    turns), one ``/api/tts-stream`` request's TTFA. K4's shapes are counted
    into ``shapes`` on untimed runs. Returns the K4 and K1 launches of the
    served paths."""
    import torch

    from tts_tpu_torch.api import TTS
    from tts_tpu_torch.audio.numpy_transforms import save_wav
    from tts_tpu_torch.models.xtts.config import XttsConfig
    from tts_tpu_torch.models.xtts.model import Xtts
    from tts_tpu_torch.models.xtts.tokenizer import write_char_vocab
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.ops.quant import int8_linear, quantized_bytes
    from tts_tpu_torch.server.server import close_server, create_server

    import shutil

    cuda = torch.device(device).type == "cuda"
    shapes = {} if shapes is None else shapes
    t0 = time.time()
    config = config or XttsConfig()
    cpu = Xtts(config).init_params(seed=0, device="cpu")
    stop = cpu.gpt.stop_audio_token
    cpu.gpt.mel_head.bias[stop] = -1e4  # every stream decodes its whole length
    n_layers = len(cpu.gpt.gpt.h)
    per_step = 4 * n_layers + 1  # c_attn, c_proj, mlp_fc, mlp_proj a layer; the mel head
    fp32_gpt = quantized_bytes(cpu.gpt)
    d = tempfile.mkdtemp(prefix="xtts_int8_")
    cfg = config.to_dict()
    cfg["model_args"]["gpt_int8_weights"] = True
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f, default=str)
    write_char_vocab(os.path.join(d, "vocab.json"), "abcdefghijklmnopqrstuvwxyz.,!?'-")
    state = {k: v.bfloat16() if k.startswith("gpt.") else v
             for k, v in cpu.state_dict_with_stats().items()}  # the served GPT in bf16
    bf16_gpt = sum(v.numel() * v.element_size() for k, v in state.items() if k.startswith("gpt."))
    torch.save(state, os.path.join(d, "model_torch.pt"))
    del state
    wav_path = os.path.join(d, "ref.wav")
    save_wav(wav=reference_wav(seconds=4.0, seed=1), path=wav_path, sample_rate=22050)

    model = Xtts(config)  # the same weights on the card (the GPT's lock cannot be copied)
    model.load_state_dict_with_stats({k: v.to(device, copy=True)
                                      for k, v in cpu.state_dict_with_stats().items()})
    before = allocated(device)
    model.quantize_weights_int8()
    freed = before - allocated(device)
    cpu.quantize_weights_int8()
    log(f"XTTS v2 int8 ({n_layers} layers, fp32 weights from seed 0, ready in "
        f"{time.time() - t0:.1f} s): GPT {fp32_gpt / 1e9:.3f} GB fp32 -> "
        f"{quantized_bytes(model.gpt) / 1e9:.3f} GB int8 with scales; quantizing on the card "
        f"freed {freed / 1e9:.3f} GB")

    # card against CPU, fp32
    wav = reference_wav(seconds=4.0, seed=1)
    rs = np.random.RandomState(20)
    n_text = min(200, model.args.gpt_number_text_tokens)
    text = torch.from_numpy(rs.randint(5, n_text, (1, 40)))
    lengths = torch.tensor([40])
    outs = {}
    for m, dev in ((model, device), (cpu, "cpu")):
        with recorded_int8_shapes(shapes if m is model else {}):
            cond = m.get_gpt_cond_latents(wav, 22050, chunk_length=4)
            state = m.gpt.prefill(cond, text.to(dev), lengths.to(dev), max_new_tokens=8)
            g = m.gpt.generate(cond, text.to(dev), lengths.to(dev), None, max_new_tokens=8,
                               top_k=1)
        outs[dev] = dict(cond=cond, logits=state["last_logits"], latents=g["latents"],
                         codes=g["codes"])
    errs = {k: peak_err(outs[device][k], outs["cpu"][k]) for k in ("cond", "logits", "latents")}
    if not torch.equal(outs[device]["codes"].cpu(), outs["cpu"]["codes"]):
        raise AssertionError("int8 XTTS: greedy codes differ card against CPU")
    if not max(errs.values()) <= INT8_MODEL_TOL:
        raise AssertionError(f"int8 XTTS card against CPU: {errs}")
    log("int8 XTTS card against CPU (fp32; conditioning through the quantized encoder and "
        "perceiver, the prefill, 8 greedy steps), as a share of each peak (tol 1e-4): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + " | " + card)
    cond = outs[device]["cond"]
    del cpu, outs

    # K4 against its plain version on the card, 40 greedy tokens (fp32)
    text, lengths = text.to(device), lengths.to(device)
    int8_linear.launches = decode_attention.launches = 0
    steps0 = model.gpt.decode_steps
    with_k4 = model.gpt.generate(cond, text, lengths, None, max_new_tokens=40, top_k=1)
    sync(device)
    steps, launches = model.gpt.decode_steps - steps0, int8_linear.launches
    with plain_int8_linear(), recorded_int8_shapes(shapes):
        with_plain = model.gpt.generate(cond, text, lengths, None, max_new_tokens=40, top_k=1)
    sync(device)
    if not torch.equal(with_k4["codes"], with_plain["codes"]):
        raise AssertionError("int8 XTTS: codes differ through K4 and its plain version")
    lat_err = peak_err(with_k4["latents"], with_plain["latents"])
    if cuda and (launches != per_step * (steps + 1) or int8_linear.launches != launches):
        raise AssertionError(f"int8 XTTS: {launches} K4 launches for {steps} steps and a "
                             f"prefill, want {per_step} each")
    log(f"int8 XTTS: 40 greedy tokens identical through K4 and its plain version on the card "
        f"(fp32), latents {lat_err:.3g} of their peak; K4 {launches} launches = {per_step} x "
        f"({steps} steps + the prefill), K1 {decode_attention.launches} = {n_layers} x {steps}")
    del model, with_k4, with_plain

    # served from the model directory: the flag from config.json, the GPT in bf16
    float_cfg = XttsConfig.from_dict(config.to_dict())
    base = allocated(device)
    floats = Xtts(float_cfg).load_checkpoint(float_cfg, checkpoint_dir=d, device=device)
    float_resident, float_model = allocated(device) - base, quantized_bytes(floats)
    base = allocated(device)
    tts = TTS(model_path=d, device=device)
    resident = allocated(device) - base
    served = tts.synthesizer.tts_model
    int8_gpt = quantized_bytes(served.gpt)
    if served.gpt.dtype != torch.bfloat16 or not served.args.gpt_int8_weights:
        raise AssertionError("int8 XTTS: the served GPT is not the bf16 int8 one")
    # no float copy of a quantized weight stays: no linear or convolution
    # module of quantizable size is left, and what the load allocated is the
    # model's parameters and buffers within 64 MB (a float copy of the GPT's
    # weights would be 0.76 GB)
    left = [n for n, m in served.gpt.named_modules() if type(m) in (torch.nn.Linear,
            torch.nn.Conv1d) and m.weight.numel() >= 4096]
    if left or (cuda and resident > quantized_bytes(served) + (64 << 20)):
        raise AssertionError(f"int8 XTTS: {resident} bytes resident for a "
                             f"{quantized_bytes(served)}-byte model; float modules left: {left}")
    log(f"int8 XTTS through TTS (gpt_int8_weights from config.json): GPT {bf16_gpt / 1e9:.3f} GB "
        f"in bf16 -> {int8_gpt / 1e9:.3f} GB int8 with scales; whole model resident (allocated "
        f"on the card) {float_resident / 1e9:.3f} GB float -> {resident / 1e9:.3f} GB int8, of "
        f"which parameters and buffers {float_model / 1e9:.3f} -> "
        f"{quantized_bytes(served) / 1e9:.3f} GB | {card}")

    k4_total = k1_total = 0
    with recorded_int8_shapes(shapes):  # untimed: the conditioning, a prefill and 2 steps a batch
        cond, _ = served.resolve_conditioning(served.config, speaker_wav=wav_path)
        tokens, lens = served._text_batch(["the quick brown fox jumps over the lazy dog."], "en")
        for B in (1, 4):
            state = served.gpt.prefill(cond.expand(B, -1, -1), tokens.expand(B, -1),
                                       lens.expand(B), max_new_tokens=8)
            served.gpt.decode_chunk(state, None, chunk_size=2, top_k=1)
    sync(device)
    # the float model from the same directory, its GPT in bf16 as served, in turns
    floats.gpt.to(torch.bfloat16)
    for B in (1, 4):
        order = ("int8", "float", "int8 ", "float ") if B == 1 else ("int8", "float")
        step = {}
        for name in order:
            gpt = served.gpt if name.startswith("int8") else floats.gpt
            ms, k4, k1, cache = bf16_step_ms(gpt, cond, tokens, lens, B, device)
            step[name] = ms
            want_k4 = per_step * INT8_STEPS if name.startswith("int8") else 0
            if cuda and (k4 != want_k4 or k1 != n_layers * INT8_STEPS):
                raise AssertionError(f"XTTS {name.strip()} B={B}: {k4} K4 and {k1} K1 launches "
                                     f"for {INT8_STEPS} steps")
            if name.startswith("int8"):
                k4_total += k4
                k1_total += k1
        log(f"int8 XTTS decode step, bf16, B={B}, cache ~{cache}: "
            + ", ".join(f"{n.strip()} {step[n]:.2f}" for n in order)
            + f" ms (host clock, synchronized; int8 and the float model from the same directory "
            f"in turns); K4 {per_step} and K1 {n_layers} launches an int8 step | {card}")
    del floats

    srv = create_server(tts.synthesizer, port=0, stream_batch=4, stream_window_ms=50)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    res: dict = {}
    try:
        int8_linear.launches = decode_attention.launches = 0
        url = (f"http://127.0.0.1:{srv.server_address[1]}/api/tts-stream?text="
               f"{urllib.parse.quote('the quick brown fox jumps over the lazy dog.')}"
               f"&language_id=en&speaker_wav={urllib.parse.quote(wav_path)}")
        _fetch(url, res, "stream")
        sync(device)
        k4, k1 = int8_linear.launches, decode_attention.launches
    finally:
        close_server(srv)
        thread.join(timeout=60)
    body = res["stream"]["body"]
    pcm = np.frombuffer(body[44:], dtype="<i2")
    if res["stream"]["status"] != 200 or body[:4] != b"RIFF" or pcm.std() < 30:
        raise AssertionError(f"int8 /api/tts-stream: HTTP {res['stream']['status']}, "
                             f"{len(pcm)} samples, std {pcm.std():.1f}")
    if cuda and (k4 == 0 or k1 == 0):
        raise AssertionError(f"int8 /api/tts-stream: K4 {k4}, K1 {k1} launches")
    k4_total += k4
    k1_total += k1
    log(f"int8 XTTS /api/tts-stream through the StreamBatcher: TTFA {res['stream']['ttfa'] * 1e3:.0f}"
        f" ms (50 ms batching window included), {len(pcm) / 24000:.1f} s of audio in "
        f"{res['stream']['total']:.2f} s; K4 {k4}, K1 {k1} launches | {card}")
    del tts, served
    shutil.rmtree(d, ignore_errors=True)
    return {"k4": k4_total, "k1": k1_total}


def int8_tortoise(card: str, device, config=None, shapes=None) -> dict:
    """Tortoise's ``UnifiedVoice`` at ``TortoiseArgs()`` widths, drawn on the
    card from seed 0 (fp32), quantized: 16 greedy candidates through K4 and
    through the plain version (whose run counts K4's shapes into
    ``shapes``), launches and ms a step, resident bytes."""
    import torch

    from tts_tpu_torch.models.tortoise import model as tortoise
    from tts_tpu_torch.models.tortoise.config import TortoiseConfig
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.ops.quant import int8_linear, quantized_bytes

    cuda = torch.device(device).type == "cuda"
    config = config or TortoiseConfig()
    with torch.device(device):
        model = tortoise.Tortoise(config)
    model.diffusion = None  # the AR stack alone: quantization leaves the rest float
    ar = draw_on_device(model.autoregressive, 0, device)
    n_layers = len(ar.gpt.h)
    per_step = 4 * n_layers + 1
    fp32_bytes, before = quantized_bytes(ar), allocated(device)
    model.quantize_weights_int8()
    int8_bytes, freed = quantized_bytes(ar), before - allocated(device)
    gen = torch.Generator(device).manual_seed(1)
    cond = torch.randn(1, 1, ar.mel_embedding.embedding_dim, generator=gen, device=device)
    ids = torch.tensor([model.tokenizer.encode("Tortoise speaks through sixteen candidates.")
                        + [config.model_args.ar_stop_text_token]], device=device)
    kw = dict(max_new_tokens=60, temperature=0.8, top_p=1e-6, repetition_penalty=2.0)
    runs = {}
    for name, ctx in (("K4", contextlib.nullcontext), ("plain", plain_int8_linear)):
        int8_linear.launches = decode_attention.launches = 0
        steps0 = ar.decode_steps
        record = (recorded_int8_shapes(shapes) if shapes is not None and name == "plain"
                  else contextlib.nullcontext())
        with ctx(), record:
            sync(device)
            t0 = time.perf_counter()
            out = ar.generate(cond.expand(16, -1, -1), ids.expand(16, -1), None, **kw)
            sync(device)
            wall = (time.perf_counter() - t0) * 1e3
        runs[name] = (out["codes"], ar.decode_steps - steps0, int8_linear.launches,
                      decode_attention.launches, wall)
    (c1, steps, k4, k1, wall), (c2, _, k4_plain, _, wall_plain) = runs["K4"], runs["plain"]
    if not torch.equal(c1, c2):
        raise AssertionError("int8 Tortoise: codes differ through K4 and its plain version")
    if cuda and (k4 != per_step * (steps + 1) or k4_plain != 0 or k1 != n_layers * steps):
        raise AssertionError(f"int8 Tortoise: {k4} K4 ({k4_plain} plain) and {k1} K1 launches "
                             f"for {steps} steps")
    log(f"int8 Tortoise AR ({n_layers} layers, fp32 from seed 0; {fp32_bytes / 1e9:.3f} GB fp32 "
        f"-> {int8_bytes / 1e9:.3f} GB int8, {freed / 1e9:.3f} GB freed on the card): 16 greedy "
        f"candidates x {steps} steps identical through K4 and its plain version; "
        f"{wall / steps:.2f} ms a step with K4, {wall_plain / steps:.2f} ms plain (host clock, "
        f"prefill included); K4 {k4} launches = {per_step} x ({steps} steps + the prefill), "
        f"K1 {k1} | {card}")
    return {"k4": k4, "k1": k1}


def int8_bark(card: str, device, config=None, shapes=None) -> dict:
    """Bark's three GPTs at the zoo's widths, drawn on the card from seed 0
    (fp32), quantized: the semantic stage and one coarse window, greedy,
    through K4 and through the plain version (whose run counts K4's shapes
    into ``shapes``); launches and ms a step, resident bytes."""
    import torch

    from tts_tpu_torch.models.bark.model import Bark
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.ops.quant import int8_linear, quantized_bytes

    cuda = torch.device(device).type == "cuda"
    config = config or bark_config()
    with torch.device(device):
        model = Bark(config)
    draw_on_device(model, 0, device)
    n_layers = config.semantic_config.n_layer
    per_step = 4 * n_layers + 1
    gpts = ("semantic_model", "coarse_model", "fine_model")
    fp32_bytes = sum(quantized_bytes(getattr(model, n)) for n in gpts)
    before = allocated(device)
    model.quantize_weights_int8()
    int8_bytes, freed = sum(quantized_bytes(getattr(model, n)) for n in gpts), \
        before - allocated(device)
    text = np.frombuffer("Bark speaks through int8 weights.".encode(), np.uint8).astype(np.int64)
    runs = {}
    for name, ctx in (("K4", contextlib.nullcontext), ("plain", plain_int8_linear)):
        int8_linear.launches = decode_attention.launches = 0
        steps0 = model.semantic_model.decode_steps + model.coarse_model.decode_steps
        record = (recorded_int8_shapes(shapes) if shapes is not None and name == "plain"
                  else contextlib.nullcontext())
        with ctx(), record:
            sync(device)
            t0 = time.perf_counter()
            sem = model.generate_text_semantic(text, None, max_gen_duration_s=1.0, top_k=1)
            coarse = model.generate_coarse(sem[:20], None, top_k=1)
            sync(device)
            wall = (time.perf_counter() - t0) * 1e3
        steps = model.semantic_model.decode_steps + model.coarse_model.decode_steps - steps0
        runs[name] = (sem, coarse, steps, int8_linear.launches, decode_attention.launches, wall)
    (s1, c1, steps, k4, k1, wall), (s2, c2, _, k4_plain, _, wall_plain) = runs["K4"], runs["plain"]
    if not (np.array_equal(s1, s2) and np.array_equal(c1, c2)):
        raise AssertionError("int8 Bark: tokens differ through K4 and its plain version")
    # one prefill each: the semantic prompt and the coarse window
    if cuda and (k4 != per_step * (steps + 2) or k4_plain != 0 or k1 != n_layers * steps):
        raise AssertionError(f"int8 Bark: {k4} K4 ({k4_plain} plain) and {k1} K1 launches for "
                             f"{steps} steps")
    log(f"int8 Bark (three GPTs {n_layers} x {config.semantic_config.n_embd}, fp32 from seed 0; "
        f"{fp32_bytes / 1e9:.3f} GB fp32 -> {int8_bytes / 1e9:.3f} GB int8, "
        f"{freed / 1e9:.3f} GB freed on the card): {len(s1)} greedy semantic tokens and one "
        f"coarse window ({c1.size} tokens) identical through K4 and its plain version; "
        f"{wall / steps:.2f} ms a step with K4, {wall_plain / steps:.2f} ms plain (host clock, "
        f"two prefills included); K4 {k4} launches = {per_step} x ({steps} steps + 2 prefills), "
        f"K1 {k1} | {card}")
    return {"k4": k4, "k1": k1}


def phase_int8(card: str, device="cuda", cut=None) -> tuple:
    """Phase 20: K4 against its plain version and timed (on a card), then
    int8 XTTS v2, Tortoise and Bark, then K4 timed at every other shape
    they launched. ``cut(xtts, tortoise, bark)`` shrinks the three configs
    in place for rehearsals on the CPU. Returns K4's entry of the kernels
    line (None without a card) with its launches on the served paths, and
    K1's launches there."""
    import torch

    from tts_tpu_torch.models.tortoise.config import TortoiseConfig
    from tts_tpu_torch.models.xtts.config import XttsConfig

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    kernel, times = phase_int8_kernel(card) if cuda else (None, {})
    log(f"  (phase 20 at {time.time() - t_phase:.1f} s: K4 checked and timed)")
    configs = (XttsConfig(), TortoiseConfig(), bark_config())
    if cut is not None:
        cut(*configs)
    shapes: dict = {}  # (M, K, N, type) -> K4 calls in the recorded runs
    counts = [int8_xtts(card, device, configs[0], shapes)]
    log(f"  (phase 20 at {time.time() - t_phase:.1f} s: XTTS)")
    counts.append(int8_tortoise(card, device, configs[1], shapes))
    counts.append(int8_bark(card, device, configs[2], shapes))
    log(f"  (phase 20 at {time.time() - t_phase:.1f} s: Tortoise and Bark)")
    k4, k1 = sum(c["k4"] for c in counts), sum(c["k1"] for c in counts)
    if cuda and k4 == 0:
        raise AssertionError("phase 20: K4 never launched on the served paths")
    if cuda:
        int8_served_timings(shapes, times, card)
    else:
        log(f"int8 served shapes (M K N type: calls): "
            + ", ".join(f"{k}: {n}" for k, n in sorted(shapes.items())))
    if kernel is not None:
        kernel["launches"] = k4
    log(f"phase 20 (int8 through K4) took {time.time() - t_phase:.1f} s; K4 launched {k4} times "
        f"on the served paths | {card}")
    return kernel, k1


# ---------------------------------------------------------------------------
# phase 21: the VITS train step, with MAS through K2
# ---------------------------------------------------------------------------

TRAIN_BATCH = 32  # the recipe's batch_size
TRAIN_TEXT = (61, 381)  # ids with add_blank, the longest row present
TRAIN_FRAMES = (172, 861)  # 2-10 s at 22.05 kHz, hop 256; the longest row present
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
TRAIN_TOL = 1e-4  # card against CPU, a share of each tensor's peak
BARE_STEP_MS: dict = {}  # phase 21's ms a bare step, by precision, for phase 22


def mas_bound_ms(value, mask) -> tuple:
    """Least time for one K2 call: value and mask read once and the path
    written once (value's type), over the memory rate; the forward pass's
    few operations a cell are far under the fp32 rate."""
    nbytes = value.numel() * value.element_size() * 2 + mask.numel() * mask.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * value.numel() / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes


def train_lengths(rs) -> tuple:
    """``TRAIN_BATCH`` text lengths (61-381 ids with blanks, odd) and frame
    lengths (roughly 2.26 frames a token, 172-861) drawn from ``rs``; row 0
    the longest of both, row 1 the shortest text."""
    x_len = rs.randint(TRAIN_TEXT[0] // 2, TRAIN_TEXT[1] // 2 + 1, TRAIN_BATCH) * 2 + 1
    x_len[0], x_len[1] = TRAIN_TEXT[1], TRAIN_TEXT[0]
    y_len = np.clip((x_len * rs.uniform(2.0, 2.5, TRAIN_BATCH)).astype(int), *TRAIN_FRAMES)
    y_len[0] = TRAIN_FRAMES[1]
    return x_len, y_len


def synthetic_train_batch(model, device, seed: int = 0) -> dict:
    """``TRAIN_BATCH`` rows from ``seed``: phoneme ids with blanks between
    them (61-381 ids), a voiced waveform of 2-10 s at 22.05 kHz a row (frames
    roughly 2.26 a token, as LJSpeech's), its linear spectrogram (the
    recipe's STFT), zero padding past each length."""
    import torch

    from tts_tpu_torch.audio.torch_transforms import wav_to_spec

    audio = model.config.audio
    rs = np.random.RandomState(seed)
    B = TRAIN_BATCH
    x_len, y_len = train_lengths(rs)
    chars = model.tokenizer.characters
    blank = chars.char_to_id(chars.blank)
    ids = np.full((B, TRAIN_TEXT[1]), blank, np.int64)
    for b in range(B):
        phones = rs.randint(0, chars.num_chars - 1, x_len[b] // 2)
        phones[phones >= blank] += 1  # every id but the blank's
        ids[b, 1 : x_len[b] : 2] = phones
        ids[b, x_len[b]:] = 0
    hop = audio.hop_length
    wav = np.zeros((B, TRAIN_FRAMES[1] * hop), np.float32)
    for b in range(B):
        n = y_len[b] * hop
        wav[b, :n] = reference_wav(seconds=(n + 1) / audio.sample_rate, sr=audio.sample_rate,
                                   seed=seed + b)[:n]
    wav_t = torch.from_numpy(wav).to(device)
    spec = wav_to_spec(wav_t, audio.fft_size, hop, audio.win_length).transpose(1, 2)
    frame = torch.arange(spec.shape[1], device=device)[None, :, None]
    spec = spec * (frame < torch.from_numpy(y_len).to(device)[:, None, None])
    return {"text_input": torch.from_numpy(ids).to(device),
            "text_lengths": torch.from_numpy(x_len.astype(np.int32)).to(device),
            "spec": spec.contiguous(),
            "spec_lengths": torch.from_numpy(y_len.astype(np.int32)).to(device),
            "waveform": wav_t[..., None]}


@contextlib.contextmanager
def host_draws(seed: int = 0):
    """The training step's draws (normals, segment uniforms, dropout keep
    masks) made on the host from one CPU generator, the n-th draw of each
    kind and shape the same in every run, then copied to the device: a card
    run and a CPU run get the same draws."""
    import torch

    from tts_tpu_torch.layers import common
    from tts_tpu_torch.models.vits import modules
    from tts_tpu_torch.ops import helpers

    gen = torch.Generator().manual_seed(seed)
    table, seen = {}, {}

    def draw(kind, shape, make, device):
        n = seen.get((kind, shape), 0)
        seen[(kind, shape)] = n + 1
        key = (kind, shape, n)
        if key not in table:
            table[key] = make(shape)
        return table[key].to(device)

    real = modules.normal, helpers.uniform, common.bernoulli
    modules.normal = lambda shape, g: draw("normal", tuple(shape), lambda s: torch.randn(
        s, generator=gen), g.device)
    helpers.uniform = lambda shape, g: draw("uniform", tuple(shape), lambda s: torch.rand(
        s, generator=gen), g.device)
    common.bernoulli = lambda shape, keep, g: draw(("keep", keep), tuple(shape), lambda s: (
        torch.rand(s, generator=gen) < keep), g.device)
    try:
        yield
    finally:
        modules.normal, helpers.uniform, common.bernoulli = real


def length_mask(x_len, y_len, T_x: int, T_y: int):
    """The MAS mask [B, T_x, T_y] of token and frame lengths (fp32)."""
    import torch

    dev = x_len.device
    return ((torch.arange(T_x, device=dev)[None, :, None] < x_len[:, None, None])
            & (torch.arange(T_y, device=dev)[None, None, :] < y_len[:, None, None])).float()


def k2_parts(value, mask, plan=None) -> dict:
    """One K2 launch with block 0's clock64 stamps (block 0: the batch's
    longest item): microseconds of each part by that SM's clock (cycles
    over ``%globaltimer``). The ring kernel under ``plan``: the forward pass
    (its copying warps' end, the path's zeros included, beside it), the
    scratch bits' copy into the ring, the start count and the walk back,
    the path's ones. ``plan=None``: the columns kernel (the first design): the
    forward pass, the zeroing, the start count, the walk back."""
    import torch

    from tts_tpu_torch.ops import mas

    stamps = torch.zeros(16, dtype=torch.int64, device=value.device)
    if plan is None:
        mas.launch_columns(value, mask, stamps=stamps)
    else:
        mas.launch_ring(value, mask, plan, stamps=stamps)
    torch.cuda.synchronize()
    s = stamps.tolist()
    if plan is None:
        ghz = s[4] / s[7]
        parts = {"forward": s[1], "zeroing": s[2] - s[1], "start count": s[3] - s[2],
                 "walk back": s[4] - s[3]}
    else:
        ghz = s[6] / s[7]
        parts = {"forward": s[3], "copying warps (zeros included)": s[2],
                 "bits copy": s[4] - s[3], "start count and walk back": s[5] - s[4],
                 "path ones": s[6] - s[5]}
    return {"GHz": ghz, **{k: v / ghz / 1e3 for k, v in parts.items()},
            "cycles a frame": s[1] / value.shape[2]}


def format_parts(parts: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" + ("" if k in ("GHz", "cycles a frame") else " us")
                     for k, v in parts.items())


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call (the Python call and its launch, the device
    not awaited), over ``calls`` calls after a warm one."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued / calls * 1e6


def k2_checks(batch, card: str) -> dict:
    """K2 against its plain version at the step's shapes on random, tied
    and ragged scores (the batch's masks; an item without tokens too) and at
    the ring kernel's boundaries, each call made twice: paths identical,
    repeats bit-identical. Then K2 timed beside its bound and its plain
    version, with the bits in the other place than the plan's, at the
    aligners' 190 tokens, with bf16 values and a bool mask, and against the
    columns kernel (the first design) in the same run; its host cost and
    its parts by clock64. Returns its kernels-line entry (launches filled
    in by the caller)."""
    import torch

    from tts_tpu_torch.ops import mas
    from tts_tpu_torch.ops.mas import maximum_path, maximum_path_torch

    dev = batch["text_input"].device
    B, T_x, T_y = TRAIN_BATCH, TRAIN_TEXT[1], TRAIN_FRAMES[1]
    x_len, y_len = batch["text_lengths"].long(), batch["spec_lengths"].long()
    mask = length_mask(x_len, y_len, T_x, T_y)
    gen = torch.Generator(device=dev).manual_seed(1)
    empty = mask.clone()
    empty[3] = 0
    ragged = torch.rand(B, T_x, T_y, generator=gen, device=dev) < 0.999  # holes in the masks

    def small(b, tx, ty):
        xl = torch.randint(1, tx + 1, (b,), generator=gen, device=dev)
        yl = torch.randint(1, ty + 1, (b,), generator=gen, device=dev)
        xl[0], yl[0] = tx, ty
        return torch.randn(b, tx, ty, generator=gen, device=dev), length_mask(xl, yl, tx, ty)

    big_v = torch.randn(4, 385, 870, generator=gen, device=dev)
    big_m = torch.rand(4, 385, 870, generator=gen, device=dev) < 0.99
    cases = {
        "random": (-torch.rand(B, T_x, T_y, generator=gen, device=dev) * 100, mask),
        "tied": (torch.round(torch.randn(B, T_x, T_y, generator=gen, device=dev) * 2), mask),
        "ragged": (torch.randn(B, T_x, T_y, generator=gen, device=dev), mask * ragged),
        "empty item": (torch.randn(B, T_x, T_y, generator=gen, device=dev), empty),
        "bf16": (torch.randn(B, T_x, T_y, generator=gen, device=dev).bfloat16(), mask),
        "383 x 203": small(4, 383, 203), "385 x 861": small(4, 385, 861),
        "513 x 99": small(4, 513, 99), "1030 x 861": small(4, 1030, 861),
        "unaligned view, bool mask": (big_v[:, 3:384, 5:866], big_m[:, 3:384, 5:866]),
        "4200 x 12 (columns)": small(2, 4200, 12),
    }
    launches = maximum_path.launches
    for i, (name, (value, m)) in enumerate(cases.items()):
        # the step's shapes also with the bits forced into shared memory (the
        # plan keeps them in scratch there, beside 32-frame tiles)
        for shared in (None, False, True) if i < 5 else (None, False):
            got = maximum_path(value, m, shared_bits=shared)
            again = maximum_path(value, m, shared_bits=shared)
            want = maximum_path_torch(value, m)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, again)):
                where = {None: "the planned place", False: "scratch", True: "shared memory"}[shared]
                raise AssertionError(f"K2 ({name}, bits in {where}): the path differs from the "
                                     f"plain version's ({int((got != want).sum())} cells) or "
                                     f"between calls")
    checked = maximum_path.launches - launches
    limit = mas.shared_limit(dev.index or 0)
    plan = mas.ring_plan(T_x, T_y, limit)
    value, m = cases["random"]
    # the aligners' width: the same corpus without the blanks (30-190 ids)
    m190 = length_mask((x_len - 1) // 2, y_len, 190, T_y)
    v190 = value[:, :190].contiguous()
    vb, mb = value.bfloat16(), m.bool()
    k2_ms = time_device([lambda: maximum_path(value, m)], rounds=5, replays=4)
    other = not plan.bits_shared  # the bits in the other place than the plan's
    other_ms = time_device([lambda: maximum_path(value, m, shared_bits=other)], rounds=5,
                           replays=4)
    ms190 = time_device([lambda: maximum_path(v190, m190)], rounds=5, replays=4)
    bf16_ms = time_device([lambda: maximum_path(vb, mb)], rounds=5, replays=4)
    columns_ms = time_device([lambda: mas.launch_columns(value, m)], rounds=5, replays=4)
    k2_again = time_device([lambda: maximum_path(value, m)], rounds=5, replays=4)
    host = host_us(lambda: maximum_path(value, m))
    back_to_back = time_host(lambda: maximum_path(value, m), iters=20, warmup=2) * 1e3
    parts = k2_parts(value, m, plan)
    old_parts = k2_parts(value, m)
    maximum_path.launches = launches  # comparisons and timings are not the main path's
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    maximum_path_torch(value, m)
    start.record()
    for _ in range(2):
        maximum_path_torch(value, m)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end) / 2
    bound, bound_by, nbytes = mas_bound_ms(value, m)
    bound190 = mas_bound_ms(v190, m190)[0]
    log(f"K2 (maximum_path) against its plain version: B={B} x {T_x} x {T_y} (the step's "
        f"batch masks) {', '.join(list(cases)[:5])}, the bits where planned, in scratch and in "
        f"shared memory; the ring kernel's boundaries {', '.join(list(cases)[5:])}, the bits "
        f"where planned and in scratch: "
        f"{checked} calls, paths identical, repeats bit-identical | {card}")
    log(f"K2 plan at {T_x} x {T_y}: {plan} | {card}")
    log(f"K2 fp32 B={B} x {T_x} x {T_y}: device {k2_ms * 1e3:.1f} us (again "
        f"{k2_again * 1e3:.1f}; bits in {'shared memory' if other else 'scratch'} "
        f"{other_ms * 1e3:.1f} us; the columns "
        f"kernel {columns_ms * 1e3:.1f} us in this run), plain {plain_ms:.2f} ms, bound "
        f"{bound * 1e3:.1f} us ({nbytes / 1e6:.1f} MB, {bound_by}): {100 * bound / k2_ms:.1f} "
        f"% of bound; host {host:.1f} us a call with launch (device not awaited), "
        f"{back_to_back:.1f} us back to back; no library call computes MAS | {card}")
    log(f"K2 B={B} x 190 x {T_y} (the aligners' width): device {ms190 * 1e3:.1f} us, bound "
        f"{bound190 * 1e3:.1f} us ({100 * bound190 / ms190:.1f} %); bf16 values and a bool "
        f"mask at {T_x} x {T_y}: {bf16_ms * 1e3:.1f} us, the two widenings to fp32 included "
        f"| {card}")
    log(f"K2 parts, block 0 ({T_x} x {T_y}), ring kernel: {format_parts(parts)} | {card}")
    log(f"K2 parts, block 0, the columns kernel: {format_parts(old_parts)} | {card}")
    return {"name": "maximum_path", "route": "cuda", "source": "tts_tpu_torch/csrc/mas.cu",
            "replaces": "tts_tpu/ops/mas.py:29", "max_abs_err": 0.0, "ms": k2_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def tiny_train_config():
    """The recipe shrunk for the card-against-CPU step: hidden 32, 2 encoder
    layers, 2 flows of 2 WN layers, HiFiGAN 32 channels (its upsampling kept,
    so the hop stays 256), a discriminator at width_mult 1/16."""
    config = vits_recipe_config()
    a = config.model_args
    a.hidden_channels, a.hidden_channels_ffn_text_encoder = 32, 64
    a.num_layers_text_encoder = a.num_layers_posterior_encoder = a.num_layers_flow = 2
    a.upsample_initial_channel_decoder = 32
    a.discriminator_width_mult = 1 / 16
    a.spec_segment_size = 16
    return config


def train_step_card_against_cpu(card: str, device) -> None:
    """One step at a tiny width on the card and on the CPU, same weights,
    the same host draws (dropout on) and the same alignment, fp32 with TF32
    off: losses within 1e-4 of each value, both groups' gradients within
    1e-4 of each tensor's peak (the attention key biases, zero in exact
    arithmetic, both below 1e-6 of the group's peak). The stochastic
    duration predictor's gradients are held against a float64 run on the
    CPU: its NLL takes the log of ``durations - sigmoid(z)``, which
    cancels for one-frame tokens, so an fp32 run lies up to a few 1e-4 of
    the peak from the exact gradient (2.63e-4 on the card's host at 381
    ids); the card's elementwise kernels contract multiply-adds where the
    CPU's do not, so its rounding differs in kind (measured 2.0x the CPU's
    distance): it must lie within 4x the CPU fp32 run's distance (at least
    1e-4)."""
    import torch

    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.models.vits import train as vits_train

    base = Vits.init_from_config(tiny_train_config()).init_params(seed=0, device="cpu",
                                                                  discriminator=True)
    names = vits_train.param_names(base)
    runs, paths = {}, {}
    for run, dev, dtype in (("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64),
                            ("card", device, torch.float32)):
        model = copy.deepcopy(base)
        model.module.to(dtype)
        model.discriminator.to(dtype)
        # MAS is a discrete choice: fp32 rounding of the scores (other matmul
        # orders here and there) may flip a near-tie. Every run takes the
        # CPU's alignment; how far K2's own differs is printed.
        mas = model.module._forward_mas

        def aligned(*args, mas=mas):
            path = mas(*args)
            if "cpu" not in paths:  # the first run, on the CPU
                paths["cpu"] = path
                return path
            paths["flipped"] = int((path.cpu() != paths["cpu"]).sum())
            return paths["cpu"].to(path.device)

        model.module._forward_mas = aligned
        step, _, state = model.make_train_step(model.config, torch.Generator(dev).manual_seed(0),
                                               device=dev)
        grads = {}
        apply = state.apply_updates

        def capture(g, grads=grads, apply=apply):
            grads.update({k: [t.detach().double().cpu() for t in v] for k, v in g.items()})
            return apply(g)

        state.apply_updates = capture
        batch = synthetic_train_batch(model, dev, seed=5)
        rows = torch.argsort(batch["text_lengths"].cpu())[:2].to(dev)  # the two shortest
        batch = {k: v[rows] for k, v in batch.items()}
        short = int(batch["text_lengths"].max()), int(batch["spec_lengths"].max())
        batch["text_input"] = batch["text_input"][:, : short[0]]
        batch["spec"] = batch["spec"][:, : short[1]].to(dtype)
        batch["waveform"] = batch["waveform"][:, : short[1] * 256].to(dtype)
        with host_draws(3):
            _, metrics = step(state, batch)
        sync(dev)
        runs[run] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_cpu, g_cpu), (_, g64), (m_card, g_card) = runs["cpu"], runs["cpu64"], runs["card"]
    loss_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    if not loss_err <= TRAIN_TOL:
        raise AssertionError(f"train step card against CPU: losses {m_card} against {m_cpu}")
    sdp = [i for i, n in enumerate(names["gen"]) if n.startswith("duration_predictor.")]

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    cpu_floor = max(max(rel(g_cpu["gen"][i], g64["gen"][i]) for i in sdp), TRAIN_TOL)
    worst = {"gen": 0.0, "disc": 0.0, "sdp": 0.0}
    for group in ("gen", "disc"):
        peak = max(float(t.abs().max()) for t in g_cpu[group])
        for i, (name, a, b) in enumerate(zip(names[group], g_card[group], g_cpu[group])):
            if name.endswith("conv_k.bias"):
                if not max(float(a.abs().max()), float(b.abs().max())) < 1e-6 * peak:
                    raise AssertionError(f"train step: {name}'s gradient is not noise")
            elif group == "gen" and i in sdp:
                err = rel(a, g64[group][i])
                worst["sdp"] = max(worst["sdp"], err)
                if not err <= 4 * cpu_floor:
                    raise AssertionError(f"train step: the card's {name} gradient lies {err:.3g} "
                                         f"of its peak from float64, the CPU's fp32 "
                                         f"{cpu_floor:.3g}")
            else:
                err = rel(a, b)
                worst[group] = max(worst[group], err)
                if not err <= TRAIN_TOL:
                    raise AssertionError(f"train step card against CPU: {group} {name} "
                                         f"gradient {err:.3g} of its peak > {TRAIN_TOL}")
    log(f"VITS train step card against CPU at a tiny width (hidden 32, the batch's 2 shortest "
        f"rows, {short[0]} ids at most, fp32, TF32 off, dropout on, the same host draws and the CPU's alignment; K2's "
        f"own path differed in {paths['flipped']} cells): losses within {loss_err:.3g} of each "
        f"value; gradients within {worst['gen']:.3g} (gen) and {worst['disc']:.3g} (disc) of "
        f"each tensor's peak (tol {TRAIN_TOL}); the duration predictor's {worst['sdp']:.3g} "
        f"from float64, the CPU fp32 run's {cpu_floor:.3g} | {card}")


def phase_vits_train(card: str, device="cuda", cut=None) -> dict:
    """Phase 21: the LJSpeech VITS recipe's GAN step at full width (B=32)
    on a synthetic batch from seed 0, through ``Vits.make_train_step``; MAS
    through K2 once a step. Returns K2's kernels-line entry (None off a
    card) with its launches over the full-width steps. ``cut(config)``
    shrinks the config in place for rehearsals on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.ops.mas import maximum_path

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"
    config = vits_recipe_config()
    if cut is not None:
        cut(config)
    model = Vits.init_from_config(config).init_params(seed=0, device=device, discriminator=True)
    batch = synthetic_train_batch(model, device)
    n_gen = sum(p.numel() for p in model.module.parameters()) / 1e6
    n_disc = sum(p.numel() for p in model.discriminator.parameters()) / 1e6
    log(f"VITS training (LJSpeech recipe, B={TRAIN_BATCH}: text {TRAIN_TEXT[0]}-{TRAIN_TEXT[1]} "
        f"ids, {TRAIN_FRAMES[0]}-{TRAIN_FRAMES[1]} frames, segments of "
        f"{config.model_args.spec_segment_size} frames): generator {n_gen:.2f} M, "
        f"discriminator {n_disc:.2f} M parameters (seed 0); ready in "
        f"{time.time() - t_phase:.1f} s")
    kernel = k2_checks(batch, card) if cuda else None
    if cuda:
        train_step_card_against_cpu(card, device)
        log(f"  (phase 21 at {time.time() - t_phase:.1f} s: K2 and the tiny step checked)")

    maximum_path.launches = 0
    steps_run = 0
    for mixed in (False, True):
        config.mixed_precision = mixed
        what = "bf16 autocast" if mixed else "fp32"
        step, _, state = model.make_train_step(config, torch.Generator(device).manual_seed(0),
                                               device=device)
        for _ in range(TRAIN_WARMUP):
            step(state, batch)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = []
        for _ in range(TRAIN_TIMED):
            _, metrics = step(state, batch)
            losses.append(metrics)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
        BARE_STEP_MS[what] = ms
        steps_run += TRAIN_WARMUP + TRAIN_TIMED
        last = {k: float(v) for k, v in losses[-1].items()}
        if not all(np.isfinite(float(v)) for m in losses for v in m.values()):
            raise AssertionError(f"VITS train step ({what}): a loss is not finite: {last}")
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        log(f"VITS train step {what}, B={TRAIN_BATCH}: {ms:.1f} ms a step (mean of "
            f"{TRAIN_TIMED} after {TRAIN_WARMUP} warm-up), {1e3 / ms * TRAIN_BATCH:.1f} "
            f"utterances/s; peak memory {peak:.2f} GB; last losses "
            + ", ".join(f"{k} {v:.4g}" for k, v in last.items()) + f" | {card}")
        if cuda:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                step(state, batch)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t1) * 1e6
            steps_run += 1
            log_profile(prof, f"VITS train step ({what})", wall_us, card, top=6)
    k2 = maximum_path.launches
    if cuda and k2 != steps_run:
        raise AssertionError(f"VITS training: K2 launched {k2} times in {steps_run} steps")
    if kernel is not None:
        kernel["launches"] = k2
    log(f"phase 21 (VITS train step) took {time.time() - t_phase:.1f} s; K2 launched {k2} "
        f"times in {steps_run} steps | {card}")
    return kernel



# ---------------------------------------------------------------------------
# phase 22: VITS training through the trainer loop, the data pipeline and
# train_tts
# ---------------------------------------------------------------------------

CORPUS_CLIPS = 80
CORPUS_SECONDS = (2.0, 10.0)
FRAMES_PER_ID = 2.26  # LJSpeech's pace with blanks, as phase 21's batch
CORPUS_WORDS = ("the quick brown fox jumps over a lazy dog while seven bright stars glow "
                "above quiet hills and rivers run past old stone walls toward the sea").split()
LOOP_EVAL = 16  # eval_split_size; the recipe's eval_batch_size
LOOP_TOL = 1e-4  # the tiny fit, card against CPU: each loss, a share of its own value
LOOP_FLOOR = 1e-3  # ... or of this, for a loss nearer 0
ML_LANGUAGES = ("en", "de")  # the multilingual run: four speakers in two languages
ML_CLIPS = 48  # 32 to train (one step at B=32) and LOOP_EVAL to evaluate


def write_train_corpus(root: str, tokenizer, audio, n: int = CORPUS_CLIPS, seed: int = 0):
    """An LJSpeech-layout corpus under ``root`` (``wavs/*.wav``, 16-bit, and
    ``metadata.csv``): ``n`` clips of 2-10 s drawn from ``seed`` (clip 0 the
    longest, clip 1 the shortest), voiced synthetic audio, each with a text
    whose ids (phonemes with blanks, through ``tokenizer``) come to about a
    token every 2.26 frames. Returns ``(names, seconds, ids)``."""
    import scipy.io.wavfile

    rs = np.random.RandomState(seed)
    sr, hop = audio.sample_rate, audio.hop_length
    probe = " ".join(CORPUS_WORDS)
    ids_per_word = (len(tokenizer.text_to_ids(probe)) - 1) / len(CORPUS_WORDS)
    seconds = rs.uniform(*CORPUS_SECONDS, n)
    seconds[0], seconds[1] = CORPUS_SECONDS[1], CORPUS_SECONDS[0]
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    names, n_ids, lines = [], [], []
    for i, sec in enumerate(seconds):
        name = f"LJ000-{i:04d}"
        wav = reference_wav(seconds=sec, sr=sr, seed=seed + i)
        scipy.io.wavfile.write(os.path.join(root, "wavs", name + ".wav"), sr,
                               (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        target = sec * sr / hop / FRAMES_PER_ID
        n_words = max(1, int(round((target - 1) / ids_per_word)))
        text = " ".join(rs.choice(CORPUS_WORDS, n_words)).capitalize() + "."
        lines.append(f"{name}|{text}|{text}")
        names.append(name)
        n_ids.append(len(tokenizer.text_to_ids(text)))
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return names, seconds, np.asarray(n_ids)


def write_mailabs_corpus(root: str, lj_root: str, names, seed: int = 0) -> list:
    """The LJSpeech corpus's clips ``names`` relabelled as four speakers in
    two languages, in M-AILABS's layout (``<lang>/by_book/<gender>/<speaker>/
    <book>/{metadata.csv,wavs}``, the wavs linked): speaker by clip index
    modulo 4. Returns the language folders."""
    texts = {}
    with open(os.path.join(lj_root, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            texts[cols[0]] = cols[1]
    speakers = [(lang, g, f"{g}_{lang}") for lang in ML_LANGUAGES for g in ("female", "male")]
    folders = {}
    for i, name in enumerate(names):
        lang, gender, spk = speakers[i % len(speakers)]
        book = os.path.join(root, lang, "by_book", gender, spk, "book")
        os.makedirs(os.path.join(book, "wavs"), exist_ok=True)
        os.symlink(os.path.join(lj_root, "wavs", name + ".wav"),
                   os.path.join(book, "wavs", name + ".wav"))
        with open(os.path.join(book, "metadata.csv"), "a", encoding="utf-8") as f:
            f.write(f"{name}|{texts[name]}|{texts[name]}\n")
        folders[lang] = os.path.join(root, lang)
    return [folders[lang] for lang in ML_LANGUAGES]


def loop_recipe_config(corpus: str):
    """``recipes/ljspeech/vits/train_vits.py`` as published (B=32, eval
    batch 16, ``english_cleaners``, ``en-us`` phonemes from the port's rule
    G2P, blanks, the linear spectrogram and the waveform, the ``VitsArgs``
    defaults) over ``corpus``, with ``eval_split_size`` 16, ``print_step``
    1, the console dashboard, one epoch and one test sentence."""
    from tts_tpu_torch.config.shared import BaseDatasetConfig

    config = vits_recipe_config()
    config.batch_size, config.eval_batch_size, config.epochs = TRAIN_BATCH, LOOP_EVAL, 1
    config.compute_linear_spec = config.return_wav = True
    config.eval_split_size, config.print_step = LOOP_EVAL, 1
    config.dashboard_logger = "console"
    config.test_sentences = ["It took me quite a long time to develop a voice."]
    config.datasets = [BaseDatasetConfig(formatter="ljspeech", dataset_name="ljspeech",
                                         meta_file_train="metadata.csv", path=corpus,
                                         language="en")]
    return config


def multilingual_train_config(folders, d: str):
    """``recipes/multilingual/vits_tts/train_vits_tts.py``: B=32, eval batch
    16, graphemes with ``multilingual_cleaners``, speaker and language
    embeddings (the ``VitsArgs`` defaults: 256 and 4 channels), both
    balancer samplers, M-AILABS datasets; its speakers and languages
    written as id files (the recipe builds the same managers from the
    samples); one epoch, no test sentence (``test_run`` passes no speaker
    or language, as the JAX trainer's does). The eval split is taken per
    dataset: 8 clips of each language's 24."""
    from tts_tpu_torch.config.shared import BaseDatasetConfig
    from tts_tpu_torch.models.vits import VitsConfig

    datasets = [BaseDatasetConfig(formatter="mailabs", dataset_name="mailabs", path=p,
                                  meta_file_train="", language=os.path.basename(p))
                for p in folders]
    config = VitsConfig(batch_size=TRAIN_BATCH, eval_batch_size=LOOP_EVAL, epochs=1,
                        text_cleaner="multilingual_cleaners", use_phonemes=False,
                        compute_linear_spec=True, return_wav=True,
                        use_language_weighted_sampler=True, use_speaker_weighted_sampler=True,
                        print_step=1, datasets=datasets, dashboard_logger="console",
                        eval_split_size=LOOP_EVAL // len(folders), test_sentences=[])
    a = config.model_args
    a.num_chars = None
    a.use_speaker_embedding = a.use_language_embedding = True
    speakers = sorted(f"{g}_{lang}" for lang in ML_LANGUAGES for g in ("female", "male"))
    a.speakers_file = write_json(os.path.join(d, "speakers.json"),
                                 {n: i for i, n in enumerate(speakers)})
    a.language_ids_file = write_json(os.path.join(d, "language_ids.json"),
                                     {c: i for i, c in enumerate(ML_LANGUAGES)})
    return config


def device_union(prof, wall_us: float) -> tuple:
    """``(share of the wall time in which the device ran anything, streams
    used)``: the union of the window's CUDA activities' intervals (kernels,
    copies) over ``wall_us``. Kernels on several streams overlap, so the sum
    of their times can pass the wall time."""
    from torch.autograd import DeviceType

    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    covered, end = 0, None
    for start, stop in sorted((e.start_ns(), e.end_ns()) for e in events):
        if end is None or start > end:
            covered += stop - start
            end = stop
        elif stop > end:
            covered += stop - end
            end = stop
    return covered / 1e3 / wall_us, len({e.device_resource_id() for e in events})


class LoopWatch:
    """Trainer callbacks that count the steps and evaluation batches a run
    makes, time each step on the device's clock edge (synchronized at both
    ends), read the loader's wait, and profile one step's device activity."""

    def __init__(self, device, profile_step: int = 0, what: str = "train_tts step"):
        import torch

        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.profile_step, self.busy, self.what = profile_step, None, what
        self.union_busy, self.streams = None, 0
        self.marks = {"made": time.perf_counter()}  # perf_counter at each stage of a run
        self.steps = self.eval_batches = 0
        self.step_ms, self.wait_ms = [], []

    def start(self, trainer):
        sync(self.device)
        self.marks.setdefault("first_step", time.perf_counter())
        self.steps += 1
        self.wait_ms.append(trainer.loader_time * 1e3)
        self.prof = None
        if self.cuda and self.steps == self.profile_step:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.perf_counter()

    def end(self, trainer):
        sync(self.device)
        self.step_ms.append((time.perf_counter() - self.t0) * 1e3)
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.busy = log_profile(self.prof, self.what, self.step_ms[-1] * 1e3, self.card,
                                    top=4)
            self.union_busy, self.streams = device_union(self.prof, self.step_ms[-1] * 1e3)

    def init_end(self, trainer):
        self.marks["built"] = time.perf_counter()

    def epoch_end(self, trainer):
        self.marks.setdefault("epoch_end", time.perf_counter())
        n_eval = len(trainer.eval_samples)
        if n_eval and trainer.config.run_eval:
            self.eval_batches += -(-n_eval // max(1, trainer.config.eval_batch_size))

    def callbacks(self, card: str) -> dict:
        self.card = card
        return {"on_init_end": self.init_end, "on_train_step_start": self.start,
                "on_train_step_end": self.end, "on_epoch_end": self.epoch_end}


class LossRecorder:
    """A dashboard that keeps the trainer's scalars (the console's prints
    stay the trainer's own)."""

    def __init__(self):
        self.scalars = []

    def add_scalars(self, scope, scalars, step):
        self.scalars.append((scope, step, {k: float(v) for k, v in scalars.items()}))

    def add_figures(self, *args):
        pass

    def add_audios(self, *args):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def tiny_fit(config, samples, device, paths: dict, seed: int = 3) -> list:
    """One ``Trainer.fit`` of ``config`` (weights from ``config.seed``, drawn
    on the host) on ``device`` with the host's draws (``host_draws``) and
    MAS taken from ``paths`` when it holds the CPU run's alignments (else
    recorded there). Returns the loss scalars of every step and of the
    evaluation."""
    import torch

    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs

    model = Vits.init_from_config(copy.deepcopy(config))
    mas = model.module._forward_mas
    record = "cpu" not in paths
    calls = paths.setdefault("cpu", [])
    idx = iter(range(10**6))

    def aligned(*args):
        path = mas(*args)
        if record:
            calls.append(path.cpu())
            return path
        want = calls[next(idx)]
        paths["flipped"] = paths.get("flipped", 0) + int((path.cpu() != want).sum())
        return want.to(path.device)

    model.module._forward_mas = aligned
    recorder = LossRecorder()
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
        t = Trainer(TrainerArgs(), copy.deepcopy(config), out, model,
                    copy.deepcopy(samples[0]), copy.deepcopy(samples[1]), device=device)
        t.dashboard = recorder
        with host_draws(seed):
            t.fit()
    sync(device)
    del model, t
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return [(scope, step, {k: v for k, v in m.items() if k.startswith("loss")})
            for scope, step, m in recorder.scalars]


def tiny_loop_configs(lj_root: str, ml_folders, d: str) -> dict:
    """The card-against-CPU fits: ``tiny_train_config`` (hidden 32, the hop
    kept) at B=4, two steps an epoch, no evaluation (4 clips held out);
    single-speaker over the LJSpeech corpus's ``metadata_tiny.csv``, and
    with speaker and language embeddings over the short M-AILABS tree
    (graphemes)."""
    from tts_tpu_torch.config.shared import BaseDatasetConfig

    single = tiny_train_config()
    multi = tiny_train_config()
    for c in (single, multi):
        c.batch_size = c.eval_batch_size = c.eval_split_size = 4
        c.epochs, c.print_step, c.dashboard_logger = 1, 1, "console"
        c.compute_linear_spec = c.return_wav = True
        c.test_sentences, c.run_eval = [], False
    single.datasets = [BaseDatasetConfig(formatter="ljspeech", dataset_name="ljspeech",
                                         meta_file_train="metadata_tiny.csv", path=lj_root,
                                         language="en")]
    multi.text_cleaner, multi.use_phonemes, multi.phoneme_language = (
        "multilingual_cleaners", False, None)
    multi.datasets = [BaseDatasetConfig(formatter="mailabs", dataset_name="mailabs", path=p,
                                        meta_file_train="", language=os.path.basename(p))
                      for p in ml_folders]
    multi.eval_split_size = 4 // len(ml_folders)  # the split is taken per dataset
    a = multi.model_args
    a.use_speaker_embedding = a.use_language_embedding = True
    speakers = sorted(f"{g}_{lang}" for lang in ML_LANGUAGES for g in ("female", "male"))
    a.speakers_file = write_json(os.path.join(d, "tiny_speakers.json"),
                                 {n: i for i, n in enumerate(speakers)})
    a.language_ids_file = write_json(os.path.join(d, "tiny_language_ids.json"),
                                     {c: i for i, c in enumerate(ML_LANGUAGES)})
    return {"single-speaker": single, "multi-speaker": multi}


def fit_card_against_cpu(configs: dict, device, card: str) -> int:
    """Each tiny config through ``Trainer.fit`` on the CPU, then on the card,
    with the same weights, host draws (dropout on) and the CPU run's
    alignments, fp32 with TF32 off: every loss of every step within
    ``LOOP_TOL`` of its own value (of ``LOOP_FLOOR`` nearer 0). Returns the
    card runs' train steps (K2's launches there)."""
    from tts_tpu_torch.data import load_tts_samples

    k2 = 0
    for name, config in configs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            samples = load_tts_samples([ds.to_dict() for ds in config.datasets], eval_split=True,
                                       eval_split_size=config.eval_split_size)
        paths: dict = {}
        cpu = tiny_fit(config, samples, "cpu", paths)
        card_run = tiny_fit(config, samples, device, paths)
        if [(s, n) for s, n, _ in cpu] != [(s, n) for s, n, _ in card_run] or len(cpu) < 2:
            raise AssertionError(f"tiny fit ({name}): the runs logged {cpu} and {card_run}")
        worst = 0.0
        for (scope, step, want), (_, _, got) in zip(cpu, card_run):
            err = max(abs(got[k] - want[k]) / max(abs(want[k]), LOOP_FLOOR) for k in want)
            worst = max(worst, err)
            if not err <= LOOP_TOL:
                raise AssertionError(f"tiny fit ({name}) card against CPU, {scope} at step "
                                     f"{step}: {got} against {want}")
        n_steps = sum(scope == "train" for scope, _, _ in cpu)
        k2 += n_steps + sum(scope == "eval" for scope, _, _ in cpu)
        log(f"tiny fit card against CPU ({name}; hidden 32, B=4, {n_steps} steps through "
            f"Trainer.fit, fp32, TF32 off, dropout on, host draws, the CPU's "
            f"alignment; K2's own path differed in {paths.get('flipped', 0)} cells): losses "
            f"each within {worst:.3g} of its own value (tol {LOOP_TOL}) | {card}")
    return k2


def phase_train_loop(card: str, kernel=None, device="cuda", cut=None):
    """Phase 22: the LJSpeech VITS recipe trained from a corpus on disk
    through ``tts_tpu_torch.bin.train_tts`` on the card (0 and 4 loader
    workers), resumed with ``--continue_path``, its ``best_model.pth`` spoken
    through the ``tts`` command line; the multilingual recipe (speakers,
    languages, both balancer samplers) for one step; a tiny config through
    ``Trainer.fit`` card against CPU, with and without speakers. K2 launches
    once a train step and once an evaluation batch. ``kernel``: K2's
    kernels-line entry from phase 21, else K2 is checked here. Returns the
    entry with this phase's launches added. ``cut(config)`` shrinks the
    recipe configs in place for rehearsals on the CPU."""
    import scipy.io.wavfile
    import torch

    from tts_tpu_torch.bin import synthesize, train_tts
    from tts_tpu_torch.models.vits import Vits
    from tts_tpu_torch.ops.mas import maximum_path
    from tts_tpu_torch.text.tokenizer import TTSTokenizer

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"

    def stamp(what: str) -> None:
        log(f"  (phase 22 at {time.time() - t_phase:.1f} s: {what})")

    if kernel is None and cuda:  # phase 21 did not run: K2's card checks here
        batch = synthetic_train_batch(Vits.init_from_config(vits_recipe_config()), device)
        kernel = k2_checks(batch, card)
        kernel["launches"] = 0
        del batch
        stamp("K2 checked")
    with tempfile.TemporaryDirectory() as d:
        lj = os.path.join(d, "LJSpeech")
        config = loop_recipe_config(lj)
        if cut is not None:
            cut(config)
        tokenizer, _ = TTSTokenizer.init_from_config(copy.deepcopy(config))
        names, seconds, n_ids = write_train_corpus(lj, tokenizer, config.audio)
        order = np.argsort(seconds)
        ml_root, tiny_ml = os.path.join(d, "mailabs"), os.path.join(d, "mailabs_tiny")
        ml_folders = write_mailabs_corpus(ml_root, lj, [names[i] for i in range(ML_CLIPS)])
        tiny_folders = write_mailabs_corpus(tiny_ml, lj, [names[i] for i in order[:12]])
        with open(os.path.join(lj, "metadata.csv"), encoding="utf-8") as f:
            rows = f.read().splitlines()
        with open(os.path.join(lj, "metadata_tiny.csv"), "w", encoding="utf-8") as f:
            f.write("\n".join(rows[i] for i in order[:12]) + "\n")
        frames = (seconds * config.audio.sample_rate / config.audio.hop_length).astype(int)
        log(f"corpus: {len(names)} clips of synthetic 22.05 kHz 16-bit audio from seed 0, "
            f"{seconds.min():.1f}-{seconds.max():.1f} s ({frames.min()}-{frames.max()} frames), "
            f"{n_ids.min()}-{n_ids.max()} ids (phonemes with blanks), "
            f"{frames.sum() / n_ids.sum():.2f} frames an id; the multilingual run's "
            f"{ML_CLIPS} relabelled as 4 speakers in 2 languages")

        maximum_path.launches = 0
        expected = 0
        runs = {}
        for workers in (0, 4):
            run_dir = os.path.join(d, f"run{workers}")
            config.num_loader_workers = workers
            cfg_path = os.path.join(d, f"config{workers}.json")
            config.save_json(cfg_path)
            # the second run keeps no best model: only the first's is spoken
            extra = ["--coqpit.save_best_after", "1000000000"] if workers else []
            watch = LoopWatch(device, profile_step=2)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            t = train_tts.main(["--config_path", cfg_path, "--output_path", run_dir,
                                "--device", str(device)] + extra,
                               callbacks=watch.callbacks(card))
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
            expected += watch.steps + watch.eval_batches
            runs[workers] = (t, watch)
            files = sorted(os.listdir(run_dir))
            want = ["best_model.pth"] * (not workers) + [f"checkpoint_{t.global_step}.pth",
                                                         "config.json"]
            if files != want:
                raise AssertionError(f"train_tts ({workers} workers) wrote {files}")
            if not t.last_test_audios or not all(
                    np.isfinite(w).all() and len(w) for w in t.last_test_audios.values()):
                raise AssertionError("train_tts: the test sentence gave no finite audio")
            if not np.isfinite(t.best_loss):
                raise AssertionError(f"train_tts: best loss {t.best_loss}")
            bare = BARE_STEP_MS.get("fp32")
            log(f"train_tts, LJSpeech recipe, B={TRAIN_BATCH}, {workers} loader workers "
                f"({'thread' if workers else 'in the loop'}): {watch.steps} steps "
                + ", ".join(f"{ms:.1f}" for ms in watch.step_ms) + " ms on the trainer's "
                f"clock (synchronized; the first warms up) against phase 21's bare fp32 step "
                + (f"{bare:.1f} ms" if bare else "(phase 21 not run)")
                + "; the loop waited on the loader "
                + ", ".join(f"{ms:.1f}" for ms in watch.wait_ms) + " ms before them; busy "
                + (f"{100 * watch.busy:.1f} %" if watch.busy is not None else "not measured")
                + f" over step 2; {watch.eval_batches} eval batch of {LOOP_EVAL}, a test "
                f"sentence, best loss {t.best_loss:.4g}; peak memory {peak:.2f} GB; "
                f"{wall:.1f} s in all | {card}")
            stamp(f"{workers} workers")

        # 2. --continue_path: the step, the best loss and the optimizer's
        # update count go on where they stopped, then one more epoch
        first, _ = runs[0]
        run0 = os.path.join(d, "run0")
        watch = LoopWatch(device)
        r = train_tts.main(["--config_path", os.path.join(run0, "config.json"),
                            "--continue_path", run0, "--device", str(device),
                            "--coqpit.epochs", "2"], callbacks=watch.callbacks(card))
        expected += watch.steps + watch.eval_batches
        counts = {k: o.count for k, o in r.state.opt_states.items()}
        if (r.global_step != 2 * first.global_step or r.epochs_done != 2
                or any(c != r.global_step for c in counts.values())
                or not r.best_loss <= first.best_loss):
            raise AssertionError(f"--continue_path: step {r.global_step}, epochs "
                                 f"{r.epochs_done}, updates {counts}, best loss "
                                 f"{r.best_loss} after {first.best_loss}")
        log(f"--continue_path: resumed at step {first.global_step} (best loss "
            f"{first.best_loss:.4g}, epochs done 1), ran to step {r.global_step} (updates "
            f"{counts}, best loss {r.best_loss:.4g}, epochs done {r.epochs_done}); steps "
            + ", ".join(f"{ms:.1f}" for ms in watch.step_ms) + f" ms | {card}")
        del first, runs, r
        stamp("resumed")

        # 3. best_model.pth speaks through the tts command line
        wav_path = os.path.join(d, "best.wav")
        with contextlib.redirect_stdout(io.StringIO()):
            synthesize.main(["--text", "It took me quite a long time to develop a voice.",
                             "--model_path", os.path.join(run0, "best_model.pth"),
                             "--config_path", os.path.join(run0, "config.json"),
                             "--out_path", wav_path, "--device", str(device)])
        sr, pcm = scipy.io.wavfile.read(wav_path)
        if not len(pcm) or not np.isfinite(pcm.astype(np.float64)).all():
            raise AssertionError(f"tts on best_model.pth: {len(pcm)} samples")
        log(f"tts --model_path run/best_model.pth: {len(pcm)} samples ({len(pcm) / sr:.2f} s at "
            f"{sr} Hz), finite | {card}")

        # 4. the multilingual recipe, one step
        ml = multilingual_train_config(ml_folders, d)
        if cut is not None:
            cut(ml)
        ml_path = os.path.join(d, "multilingual.json")
        ml.save_json(ml_path)
        watch = LoopWatch(device)
        m = train_tts.main(["--config_path", ml_path, "--output_path",
                            os.path.join(d, "run_ml"), "--device", str(device),
                            "--coqpit.save_best_after", "1000000000"],
                           callbacks=watch.callbacks(card))
        expected += watch.steps + watch.eval_batches
        if watch.steps != 1 or not np.isfinite(m.best_loss):
            raise AssertionError(f"multilingual: {watch.steps} steps, best loss {m.best_loss}")
        log(f"train_tts, multilingual recipe (B={TRAIN_BATCH}, {m.model.args.num_speakers} "
            f"speakers, {m.model.args.num_languages} languages, speaker and language weighted "
            f"sampling): 1 step {watch.step_ms[0]:.1f} ms (the loader waited "
            f"{watch.wait_ms[0]:.1f} ms), eval loss {m.best_loss:.4g} | {card}")
        del m
        stamp("multilingual")

        # 5. a tiny config through Trainer.fit, card against CPU
        if cuda:
            expected += fit_card_against_cpu(tiny_loop_configs(lj, tiny_folders, d), device,
                                             card)
            stamp("tiny fits")
    launches = maximum_path.launches
    if cuda and launches != expected:
        raise AssertionError(f"phase 22: K2 launched {launches} times, the train steps and "
                             f"eval batches were {expected}")
    if kernel is not None:
        kernel["launches"] += launches
    log(f"phase 22 (train_tts, the trainer loop and the data pipeline) took "
        f"{time.time() - t_phase:.1f} s; K2 launched {launches} times = {expected} train steps "
        f"and eval batches | {card}")
    return kernel


VOC_CLIPS = 106  # 96 to train (three full steps at B=32) and VOC_EVAL to evaluate
VOC_EVAL = 10  # the vocoder configs' eval_split_size
VOC_WORKERS = 4  # loader threads
VOC_TOL = 1e-4  # the tiny fits, card against CPU: each loss, a share of its own value
VOC_FLOOR = 1e-3  # ... or of this, for a loss nearer 0
VOC_TINY_CLIPS = 12  # the tiny fits' corpus: 8 to train (two steps at B=4), 4 to evaluate


def write_wav_corpus(root: str, n: int = VOC_CLIPS, sr: int = 22050, seed: int = 0):
    """``n`` clips of 2-10 s (clip 0 the longest, clip 1 the shortest) of
    synthetic 22.05 kHz 16-bit audio under ``root``. Returns the seconds."""
    import scipy.io.wavfile

    rs = np.random.RandomState(seed)
    seconds = rs.uniform(*CORPUS_SECONDS, n)
    seconds[0], seconds[1] = CORPUS_SECONDS[1], CORPUS_SECONDS[0]
    os.makedirs(root, exist_ok=True)
    for i, sec in enumerate(seconds):
        wav = reference_wav(seconds=sec, sr=sr, seed=seed + i)
        scipy.io.wavfile.write(os.path.join(root, f"clip{i:04d}.wav"), sr,
                               (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return seconds


def vocoder_recipe_config(name: str, data_path: str):
    """The LJSpeech vocoder recipes (``recipes/ljspeech/{hifigan,
    multiband_melgan,univnet,wavegrad,wavernn}``) as published, over
    ``data_path``, with ``print_step`` 1, the console dashboard, one epoch
    and ``VOC_WORKERS`` loader threads."""
    from tts_tpu_torch.vocoder import configs

    common = dict(eval_batch_size=16, epochs=1, print_step=1, data_path=data_path,
                  dashboard_logger="console", num_loader_workers=VOC_WORKERS, save_step=0)
    if name == "hifigan":
        return configs.HifiganConfig(batch_size=32, seq_len=8192, pad_short=2000,
                                     use_noise_augment=True, **common)
    if name == "multiband_melgan":
        return configs.MultibandMelganConfig(batch_size=64, seq_len=8192, pad_short=2000,
                                             **common)
    if name == "univnet":
        return configs.UnivnetConfig(batch_size=64, seq_len=8192, pad_short=2000,
                                     use_noise_augment=True, lr_gen=1e-4, lr_disc=1e-4,
                                     **common)
    if name == "wavegrad":
        return configs.WavegradConfig(batch_size=32, seq_len=6144, pad_short=2000,
                                      use_noise_augment=True, **common)
    return configs.WavernnConfig(batch_size=64, seq_len=1280, pad_short=2000, **common)


def tiny_vocoder_configs(data_path: str) -> dict:
    """The card-against-CPU fits: each family at a tiny width (hop 256 kept,
    2048-sample segments, B=4, two steps an epoch, an evaluation of 4
    clips); multi-band MelGAN's discriminator starts at step 1, so the fit
    runs the gate off, then on. The two families under an STFT loss
    (multi-band MelGAN, UnivNet) step at lr 1e-6: their generator gradients
    are ill-conditioned (the log magnitude divides by each bin's size; any
    two fp32 evaluations sit ~1e-3 of the peak apart,
    ``tests/test_torch_gan_train.py``), so an update at the recipe's lr
    (1e-4, AdamW) put the eval losses 8e-4 apart card against CPU after two
    updates, and at lr 1e-3 by SGD 1.2e-4 after one (H100 runs recorded in
    PERF.md); at 1e-6 the updates, and what rounding makes of them, are
    100x smaller. The recipe steps run the recipes' lr at full width."""
    from tts_tpu_torch.vocoder import configs

    common = dict(batch_size=4, eval_batch_size=4, eval_split_size=4, epochs=1, print_step=1,
                  data_path=data_path, dashboard_logger="console", seq_len=2048, pad_short=0,
                  save_step=0, test_delay_epochs=10**9)
    small_lr = dict(lr_gen=1e-6, lr_disc=1e-6)
    return {
        "hifigan": configs.HifiganConfig(
            generator_model_params=dict(upsample_factors=[8, 8, 4],
                                        upsample_kernel_sizes=[16, 16, 8],
                                        upsample_initial_channel=32, resblock_kernel_sizes=[3],
                                        resblock_dilation_sizes=[[1, 3]], resblock_type="1"),
            discriminator_model_params=dict(width_mult=1 / 32), use_noise_augment=True,
            **common),
        "multiband_melgan": configs.MultibandMelganConfig(
            generator_model_params=dict(upsample_factors=[8, 4, 2], base_channels=32,
                                        num_res_blocks=1),
            discriminator_model_params=dict(base_channels=4, max_channels=32,
                                            downsample_factors=[4, 4]),
            steps_to_start_discriminator=1, **small_lr, **common),
        "univnet": configs.UnivnetConfig(
            generator_model_params=dict(in_channels=8, hidden_channels=8,
                                        upsample_factors=[8, 8, 4], lvc_layers_each_block=2,
                                        kpnet_hidden_channels=8),
            discriminator_model="parallel_wavegan_discriminator",
            discriminator_model_params=dict(num_layers=4, conv_channels=8), **small_lr,
            **common),
        "wavegrad": configs.WavegradConfig(
            model_params=dict(y_conv_channels=8, x_conv_channels=16,
                              dblock_out_channels=[8, 8, 16, 16],
                              ublock_out_channels=[16, 16, 8, 8, 8]),
            train_noise_schedule={"min_val": 1e-6, "max_val": 1e-2, "num_steps": 50},
            **common),
        "wavernn": configs.WavernnConfig(
            model_args=dict(rnn_dims=16, fc_dims=16, compute_dims=8, res_out_dims=8,
                            num_res_blocks=1, upsample_factors=[4, 8, 8]), **common),
    }


@contextlib.contextmanager
def vocoder_host_draws():
    """The vocoders' step draws made on the host: WaveGrad's ``draw`` and
    the noise of ParallelWaveGAN and UnivNet come from a CPU generator
    seeded with the step generator's seed, so the CPU and the card draw
    the same numbers (each draws once a step)."""
    import torch

    from tts_tpu_torch.vocoder.models.parallel_wavegan_generator import ParallelWaveganGenerator
    from tts_tpu_torch.vocoder.models.univnet_generator import UnivnetGenerator
    from tts_tpu_torch.vocoder.models.wavegrad import WavegradVocoder

    def on_host(fn):
        def wrapped(self, x, generator=None):
            return fn(self, x, torch.Generator().manual_seed(generator.initial_seed()))
        return wrapped

    saved = [(cls, name, getattr(cls, name)) for cls, name in (
        (WavegradVocoder, "draw"), (ParallelWaveganGenerator, "noise"),
        (UnivnetGenerator, "noise"))]
    for cls, name, fn in saved:
        setattr(cls, name, on_host(fn))
    try:
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def tiny_vocoder_fit(config, data_path: str, device) -> list:
    """One ``Trainer.fit`` of ``config`` (weights from ``config.seed``, drawn
    on the host) on ``device`` with host draws; its train and eval scalars
    (the times left out)."""
    import torch

    from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs
    from tts_tpu_torch.vocoder.dataset import load_wav_data
    from tts_tpu_torch.vocoder.models import setup_model

    eval_files, train_files = load_wav_data(data_path, config.eval_split_size)
    recorder = LossRecorder()
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
        t = Trainer(TrainerArgs(), copy.deepcopy(config), out, setup_model(copy.deepcopy(config)),
                    train_files, eval_files, device=device)
        t.dashboard = recorder
        with vocoder_host_draws():
            t.fit()
    sync(device)
    del t
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return [(scope, step, {k: v for k, v in m.items() if not k.endswith("_time")})
            for scope, step, m in recorder.scalars]


def vocoder_fits_card_against_cpu(data_path: str, device, card: str) -> None:
    """Each family's tiny fit on the CPU, then on the card, fp32 with TF32
    off, the same weights and host draws: every loss of every step and of
    the evaluation within ``VOC_TOL`` of its own value (of ``VOC_FLOOR``
    nearer 0)."""
    for name, config in tiny_vocoder_configs(data_path).items():
        cpu = tiny_vocoder_fit(config, data_path, "cpu")
        got = tiny_vocoder_fit(config, data_path, device)
        if [(s, n) for s, n, _ in cpu] != [(s, n) for s, n, _ in got] or len(cpu) < 3:
            raise AssertionError(f"tiny {name} fit: the runs logged {cpu} and {got}")
        worst = 0.0
        for (scope, step, want), (_, _, have) in zip(cpu, got):
            if set(want) != set(have):
                raise AssertionError(f"tiny {name} fit: {sorted(have)} against {sorted(want)}")
            err = max(abs(have[k] - want[k]) / max(abs(want[k]), VOC_FLOOR) for k in want)
            worst = max(worst, err)
            if not err <= VOC_TOL:
                raise AssertionError(f"tiny {name} fit card against CPU, {scope} at step {step}: "
                                     f"{have} against {want}")
        n_steps = sum(scope == "train" for scope, _, _ in cpu)
        log(f"tiny {name} fit card against CPU ({n_steps} steps and an evaluation through "
            f"Trainer.fit, B=4, fp32, TF32 off, host draws): {len(cpu[0][2])} scalars a step, "
            f"each within {worst:.3g} of its own value (tol {VOC_TOL}) | {card}")


def recipe_step(name: str, data_path: str, files, device, card: str, cut=None) -> None:
    """One recipe's steps at its published width through the trainer's
    hooks (the GAN step or the generic one): the first batch of its data
    pipeline, two steps, each timed on the device's clock edge; the losses
    finite."""
    import torch

    from tts_tpu_torch.trainer.trainer import Trainer, TrainerArgs, step_seed
    from tts_tpu_torch.vocoder.models import setup_model

    config = vocoder_recipe_config(name, data_path)
    if cut is not None:
        cut(name, config)
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
        model = setup_model(config)
        t = Trainer(TrainerArgs(), config, out, model, [], device=device)
        ds = model.get_dataset(config, files[:config.batch_size])
        batch = t._format_batch(next(ds.batches(config.batch_size, seed=0,
                                                num_workers=VOC_WORKERS)))
        ready = time.perf_counter() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ms, metrics = [], {}
        for i in range(2):
            t.generator.manual_seed(step_seed(t.seed, i))
            sync(device)
            t1 = time.perf_counter()
            t.state, metrics = t.train_step_fn(t.state, batch)
            sync(device)
            ms.append((time.perf_counter() - t1) * 1e3)
    host = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in host.values()):
        raise AssertionError(f"{name} recipe step: {host}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    n_params = sum(p.numel() for p in model.module.parameters()) + sum(
        p.numel() for p in getattr(model, "discriminator", torch.nn.Module()).parameters())
    loss = host.get("loss")
    log(f"{name} recipe step (B={config.batch_size}, seq_len {config.seq_len}, "
        f"{n_params / 1e6:.1f} M parameters, fp32): " + ", ".join(f"{v:.1f}" for v in ms)
        + f" ms (the first warms up), loss {loss:.4g}, peak {peak:.2f} GB; built and first "
        f"batch in {ready:.1f} s | {card}")
    del model, t, batch
    if cuda:
        torch.cuda.empty_cache()


def phase_vocoder_train(card: str, device="cuda", cut=None) -> None:
    """Phase 23: vocoder training. A corpus of ``VOC_CLIPS`` synthetic clips
    (2-10 s, 22.05 kHz) written under a temporary directory; the LJSpeech
    HiFiGAN recipe (v1, B=32, 8192-sample segments, noise augmentation,
    MPD and MSD, the mel L1, feature matching, mse) through
    ``tts_tpu_torch.bin.train_vocoder`` on the card: an epoch of three steps
    with ``VOC_WORKERS`` loader threads, an evaluation, a checkpoint (no
    best model: each file holds ~1 GB), then ``--continue_path`` for a
    second epoch; the checkpoint's generator
    through the ``Synthesizer``'s vocoder path vocodes an eval mel bit-equal
    to the trained module. Then two steps each of the multi-band MelGAN,
    UnivNet, WaveGrad and WaveRNN (mold) recipes at their widths, and each
    family's tiny fit on the card against the CPU. No hand-written kernel
    lies on the path: K1, K4 and K2 must launch 0 times. ``cut(name,
    config)`` shrinks each recipe config in place for rehearsals on the
    CPU."""
    import torch

    from tts_tpu_torch.bin import train_vocoder
    from tts_tpu_torch.ops.decode_attention import decode_attention
    from tts_tpu_torch.ops.mas import maximum_path
    from tts_tpu_torch.ops.quant import int8_linear
    from tts_tpu_torch.utils.synthesizer import Synthesizer
    from tts_tpu_torch.vocoder.dataset import GANDataset, load_wav_data

    t_phase = time.time()
    cuda = torch.device(device).type == "cuda"

    def stamp(what: str) -> None:
        log(f"  (phase 23 at {time.time() - t_phase:.1f} s: {what})")

    decode_attention.launches = int8_linear.launches = maximum_path.launches = 0
    with tempfile.TemporaryDirectory() as d:
        wavs = os.path.join(d, "wavs")
        seconds = write_wav_corpus(wavs)
        log(f"vocoder corpus: {len(seconds)} clips of synthetic 22.05 kHz 16-bit audio from "
            f"seed 0, {seconds.min():.1f}-{seconds.max():.1f} s")
        stamp("corpus written")

        # 1. HiFiGAN v1 through train_vocoder, then resumed
        config = vocoder_recipe_config("hifigan", wavs)
        config.save_best_after = 10**9  # one checkpoint a run: each holds ~1 GB
        if cut is not None:
            cut("hifigan", config)
        cfg_path = os.path.join(d, "hifigan.json")
        config.save_json(cfg_path)
        run = os.path.join(d, "run")
        watch = LoopWatch(device, profile_step=2, what="train_vocoder step")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t = train_vocoder.main(["--config_path", cfg_path, "--output_path", run, "--device",
                                str(device)], callbacks=watch.callbacks(card))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        files = sorted(os.listdir(run))
        want = [f"checkpoint_{t.global_step}.pth", "config.json"]
        if files != want or not np.isfinite(t.best_loss):
            raise AssertionError(f"train_vocoder wrote {files}, best loss {t.best_loss}")
        m = watch.marks
        stages = (f"built in {m['built'] - m['made']:.1f} s, first batch after "
                  f"{m['first_step'] - m['built']:.1f} s, the epoch's steps "
                  f"{m['epoch_end'] - m['first_step']:.1f} s, evaluation and checkpoint "
                  f"{t0 + wall - m['epoch_end']:.1f} s")
        n_gen = sum(p.numel() for p in t.model.module.parameters())
        n_disc = sum(p.numel() for p in t.model.discriminator.parameters())
        log(f"train_vocoder, LJSpeech HiFiGAN recipe (v1: {n_gen / 1e6:.2f} M generator, "
            f"{n_disc / 1e6:.2f} M MPD + MSD parameters), B={config.batch_size}, seq_len "
            f"{config.seq_len}, {VOC_WORKERS} loader threads: {watch.steps} steps "
            + ", ".join(f"{ms:.1f}" for ms in watch.step_ms) + " ms on the trainer's clock "
            "(synchronized; the first warms up); the loop waited on the loader "
            + ", ".join(f"{ms:.1f}" for ms in watch.wait_ms) + " ms before them; busy "
            + (f"{100 * watch.busy:.1f} % (kernel time summed), the device active "
               f"{100 * watch.union_busy:.1f} % of the wall time on {watch.streams} streams"
               if watch.busy is not None else "not measured")
            + f" over step 2; eval loss {t.best_loss:.4g}; peak memory {peak:.2f} GB; "
            f"{wall:.1f} s in all ({stages}) | {card}")
        first_step, first_best = t.global_step, t.best_loss
        del t
        stamp("HiFiGAN trained")
        watch = LoopWatch(device)
        r = train_vocoder.main(["--continue_path", run, "--device", str(device),
                                "--coqpit.epochs", "2"], callbacks=watch.callbacks(card))
        counts = {k: o.count for k, o in r.state.opt_states.items()}
        if (r.global_step != 2 * first_step or r.epochs_done != 2
                or any(c != r.global_step for c in counts.values())):
            raise AssertionError(f"--continue_path: step {r.global_step}, epochs "
                                 f"{r.epochs_done}, updates {counts}")
        log(f"--continue_path: resumed at step {first_step} (eval loss {first_best:.4g}), ran "
            f"to step {r.global_step} (updates {counts}, best loss {r.best_loss:.4g}); steps "
            + ", ".join(f"{ms:.1f}" for ms in watch.step_ms) + f" ms | {card}")
        stamp("resumed")

        # 2. the checkpoint's generator through the Synthesizer's vocoder path
        eval_files, train_files = load_wav_data(wavs, config.eval_split_size)
        mel = next(GANDataset(r.config, eval_files[:1], is_eval=True).batches(1, shuffle=False))
        mel = torch.from_numpy(mel["mel"]).to(device)
        synth = Synthesizer(vocoder_checkpoint=os.path.join(run, f"checkpoint_{r.global_step}.pth"),
                            vocoder_config=os.path.join(run, "config.json"), device=device)
        with torch.no_grad():
            got, want = synth.vocoder_model.inference(mel), r.model.module.inference(mel)
        if not torch.equal(got, want) or not torch.isfinite(got).all():
            raise AssertionError("the Synthesizer's vocoder differs from the trained generator")
        log(f"Synthesizer(vocoder_checkpoint=run/checkpoint_{r.global_step}.pth): an eval mel "
            f"of {mel.shape[1]} frames vocoded bit-equal to the trained generator "
            f"({got.shape[1]} samples, finite) | {card}")
        del r, synth, got, want
        if cuda:
            torch.cuda.empty_cache()
        stamp("vocoded through the Synthesizer")

        # 3. one recipe step each of the other families
        for name in ("multiband_melgan", "univnet", "wavegrad", "wavernn"):
            recipe_step(name, wavs, train_files, device, card, cut)
            stamp(f"{name} step")

        # 4. the tiny fits, card against CPU (CPU against CPU in a rehearsal)
        tiny = os.path.join(d, "tiny")
        os.makedirs(tiny)
        for i in np.argsort(seconds)[:VOC_TINY_CLIPS]:
            os.symlink(os.path.join(wavs, f"clip{i:04d}.wav"),
                       os.path.join(tiny, f"clip{i:04d}.wav"))
        vocoder_fits_card_against_cpu(tiny, device, card)
        stamp("tiny fits")
    launches = {"K1": decode_attention.launches, "K4": int8_linear.launches,
                "K2": maximum_path.launches}
    if any(launches.values()):
        raise AssertionError(f"phase 23: kernels launched on the vocoder training path: "
                             f"{launches}")
    log(f"phase 23 (vocoder training) took {time.time() - t_phase:.1f} s; launches on its path: "
        + ", ".join(f"{k} {v}" for k, v in launches.items()) + f" | {card}")


def selected_phases(args) -> set:
    """The phases a run does: all 23 without arguments, else phases 1 and 2
    (environment, build) and the numbers given (5 brings 4, whose model it
    serves). Raises ``ValueError`` on anything else."""
    if not args:
        return set(range(1, 24))
    chosen = {int(a) for a in args}  # ValueError on a word
    if not chosen <= set(range(1, 24)):
        raise ValueError(f"phases are 1-23, got {sorted(chosen)}")
    return chosen | {1, 2} | ({4} if 5 in chosen else set())


def main(argv=None) -> int:
    try:
        phases = selected_phases(sys.argv[1:] if argv is None else argv)
    except ValueError as err:
        print(f"chip_smoke: {err}; usage: chip_smoke.py [PHASE ...]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "tts_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    t_start = time.time()
    card = phase_environment()
    phase_build()
    kernels = []
    k1_launches = 0
    if 3 in phases:
        kernels.append(phase_kernels(card))
    if 4 in phases:
        model = phase_slice(card)
        if 5 in phases:
            k1_launches += phase_serving(model, card)
        del model
    single_ms = phase_vits(card) if 6 in phases else None
    for n, phase in ((7, phase_batched_vits), (8, functools.partial(phase_multispeaker,
                                                                    single_ms=single_ms)),
                     (9, phase_zoo_and_variants), (10, phase_glow_tts), (11, phase_tacotron2),
                     (12, phase_speaker_and_forward_tts), (13, phase_hmm_align_delightful),
                     (14, phase_vocoders), (15, phase_style_tacotron),
                     (16, phase_voice_conversion)):
        if n in phases:
            phase(card)
    for n, phase in ((17, phase_xtts_v1), (18, phase_tortoise), (19, phase_bark)):
        if n in phases:
            k1_launches += phase(card)
    if 20 in phases:
        int8_kernel, launches = phase_int8(card)
        k1_launches += launches
        kernels.append(int8_kernel)
    if 3 in phases:
        kernels[0]["launches"] = k1_launches
    k2 = phase_vits_train(card) if 21 in phases else None
    if 22 in phases:
        k2 = phase_train_loop(card, k2)
    if k2 is not None:
        kernels.append(k2)
    if 23 in phases:
        phase_vocoder_train(card)
    leaked = sorted(m for m in sys.modules if m in ("jax", "flax", "tokenizers", "transformers",
                                                   "tts_tpu")
                    or m.startswith("tts_tpu."))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    ran = "1-23" if len(phases) == 23 else ", ".join(map(str, sorted(phases)))
    log(f"chip_smoke.py: phases {ran} took {time.time() - t_start:.1f} s | {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
