"""Training loop on one device (port of ``tts_tpu/trainer/trainer.py``;
usage as the reference's ``TTS/bin/train_tts.py:58-67``: ``Trainer(args,
config, output_path, model, train_samples, eval_samples).fit()``).

A model brings its own step through the ``make_train_step`` and
``make_eval_step`` hooks (VITS: the fused GAN step of
``models/vits/train.py``; the GAN vocoders: ``vocoder/models/gan.py``), or
gives its loss through ``train_step`` and takes the trainer's generic
single-optimizer step (WaveGrad, WaveRNN; port of the JAX trainer's
``_build_generic_step`` and ``_build_eval_step``). What the JAX trainer
does, the port does:

- a model that holds no weights yet is drawn from ``config.seed`` through
  its ``init_params``;
- the data: the dataset of ``data/dataset.py`` with the model's tokenizer,
  speaker and language mappings, batched by length, weighted by the
  config's balancer switches, built ahead by ``num_loader_workers``
  threads or processes; each batch goes from pinned host memory to the
  device without blocking;
- the loop: epochs of steps with the ``on_epoch_start`` hook, the
  metrics brought to the host only every ``print_step`` steps, a
  checkpoint every ``save_step`` steps, a KeyboardInterrupt saving
  ``checkpoint_<step>_interrupted.pth``;
- evaluation over the whole eval set after each epoch, the best model
  tracked (``save_best_after``, ``save_all_best``) as ``best_model.pth``
  (and ``best_model_<step>.pth``), the test sentences spoken through
  ``utils.synthesis`` (figures only where matplotlib is installed);
- checkpoints (``utils/io.py``) pruned to ``save_n_checkpoints``, the
  last state kept where the JAX trainer prunes it (ROADMAP.md F53);
  ``--continue_path`` resumes the weights, the optimizer states (moments,
  the schedule's count, the accumulation buffer), the step, the best loss
  and the epochs done; ``--restore_path`` copies every tensor whose name
  and shape match and keeps the fresh one elsewhere.

Exact resume: a step's draws (noise, segments, dropout) come from one
``torch.Generator`` that the trainer reseeds before each step from
``(config.seed, step)``, as the JAX step draws from ``fold_in(rng,
step)``, so a resumed run draws what an uninterrupted one would.

The generic step: one optimizer (``config.optimizer``, ``lr``,
``lr_scheduler``, ``grad_clip``, ``grad_accum_steps``,
``skip_non_finite_grads``) over the ``model`` group, the parameters of the
model's ``module``; ``model.train_step(batch, generator, train=True) ->
(loss, metrics)`` under bf16 autocast with ``mixed_precision``; the
metrics gain ``loss`` and ``grad_norm`` (the global norm of the gradients,
before the clip). The JAX step's three streams (``dropout``, ``noise``,
``segments``, folded from the step's key) are the one generator here. The
evaluation, where the model has no ``make_eval_step``, runs
``train_step(..., train=False)`` without gradient on a generator seeded 0.

The JAX trainer's mesh calls (``get_mesh``, ``replicate``,
``with_data_parallel``) and its ``rank`` and ``use_ddp`` arguments have no
counterpart on one device; they wait for data parallelism (ROADMAP.md
item 18). A model with neither ``make_train_step`` nor ``train_step``
raises: the acoustic models' training is ROADMAP.md item 17d.
"""

from __future__ import annotations

import inspect
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from tts_tpu_torch import resolve_device
from tts_tpu_torch.trainer.callbacks import TrainerCallback
from tts_tpu_torch.trainer.logging import logger_factory
from tts_tpu_torch.trainer.optim import build_lr_schedule, build_optimizer
from tts_tpu_torch.trainer.precision import autocast, is_mixed_precision
from tts_tpu_torch.trainer.state import TrainState
from tts_tpu_torch.utils.io import load_checkpoint_full, save_checkpoint, save_config

CHECKPOINT_EXT = ".pth"

NO_STEP_REASON = (
    "the trainer runs models that bring their own step (make_train_step: VITS, the GAN "
    "vocoders) or their loss (train_step: WaveGrad, WaveRNN); this model has neither, and the "
    "acoustic models' training is ROADMAP.md item 17d")


@dataclass
class TrainerArgs:
    """Command-line arguments (reference ``TrainerArgs``)."""

    continue_path: str = ""
    restore_path: str = ""
    grad_accum_steps: int = 1
    skip_train_epoch: bool = False


class KeepAverage:
    """Running means of scalar metrics (reference ``generic_utils.py:185``)."""

    def __init__(self):
        self.avg: Dict[str, float] = {}
        self.n: Dict[str, int] = {}

    def update(self, values: Dict[str, float]):
        for k, v in values.items():
            if k not in self.avg:
                self.avg[k] = float(v)
                self.n[k] = 1
            else:
                self.n[k] += 1
                self.avg[k] += (float(v) - self.avg[k]) / self.n[k]


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s draws: a function of the run's seed and
    the step alone (numpy's ``SeedSequence`` of the pair)."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])


class Trainer:
    """The training runtime on one device (CUDA unless the caller asks for
    the CPU)."""

    def __init__(
        self,
        args: TrainerArgs,
        config,
        output_path: str,
        model,
        train_samples: List[dict],
        eval_samples: Optional[List[dict]] = None,
        training_assets: Optional[Dict] = None,
        callbacks: Optional[Dict] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.args = args
        self.config = config
        self.output_path = output_path
        self.model = model
        self.train_samples = train_samples
        self.eval_samples = eval_samples or []
        self.callbacks = TrainerCallback(callbacks)
        self.callbacks.on_init_start(self)
        os.makedirs(output_path, exist_ok=True)
        save_config(config, os.path.join(output_path, "config.json"))

        # the command line's grad_accum_steps overrides the config (reference
        # TrainerArgs); the model's optimizers read it back off the config
        if args.grad_accum_steps and args.grad_accum_steps > 1:
            config.grad_accum_steps = args.grad_accum_steps
        self.seed = int(getattr(config, "seed", 54321))
        if not (hasattr(model, "make_train_step") or hasattr(model, "train_step")):
            raise NotImplementedError(NO_STEP_REASON)
        if not getattr(model, "initialized", True):
            model.init_params(seed=self.seed, device=self.device, discriminator=True)
        # one generator for every step's draws, reseeded before each step
        self.generator = torch.Generator(device=self.device)
        if hasattr(model, "make_train_step"):
            self.train_step_fn, self.optimizers, self.state = model.make_train_step(
                config, self.generator, device=self.device)
        else:
            self._build_generic_step()
        self._build_eval_step()
        self.global_step = int(self.state.step)
        self.best_loss = float("inf")
        self.epochs_done = 0
        self.loader_time = 0.0  # seconds the last step waited on the loader
        self.partial_restore: Optional[tuple] = None  # (copied, kept) of --restore_path
        self.last_test_audios: Dict[str, np.ndarray] = {}
        self.dashboard = logger_factory(config, output_path)
        self._saved_checkpoints: List[str] = []
        self._restore_if_needed()
        self.callbacks.on_init_end(self)

    # ------------------------------------------------------------------
    def _build_generic_step(self):
        """One optimizer over the model's ``module`` and its loss from
        ``model.train_step`` (port of the JAX ``_build_generic_step``)."""
        config, model = self.config, self.model
        sched = build_lr_schedule(getattr(config, "lr_scheduler", None), config.lr,
                                  getattr(config, "lr_scheduler_params", {}))
        clip = getattr(config, "grad_clip", 0.0)
        clip = clip[0] if isinstance(clip, (list, tuple)) else clip
        tx = build_optimizer(config.optimizer, sched, getattr(config, "optimizer_params", {}) or {},
                             clip, int(getattr(config, "grad_accum_steps", 1) or 1),
                             bool(getattr(config, "skip_non_finite_grads", False)))
        self.optimizers = {"model": tx}
        module = model.module.to(self.device).requires_grad_(True)
        self.state = TrainState.create({"model": list(module.parameters())}, self.optimizers)
        mixed = is_mixed_precision(config)
        generator = self.generator

        def train_step(state: TrainState, batch):
            module.train()
            try:
                with autocast(self.device, mixed):
                    loss, aux = model.train_step(batch, generator, train=True)
                params = state.params["model"]
                grads = torch.autograd.grad(loss, params, allow_unused=True)
            finally:
                module.eval()
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
            metrics = {k: v.detach() for k, v in aux.items() if k != "outputs"}
            metrics["loss"] = loss.detach()
            metrics["grad_norm"] = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
            return state.apply_updates({"model": grads}), metrics

        self.train_step_fn = train_step

    def _build_eval_step(self):
        """The evaluation without gradient (port of the JAX
        ``_build_eval_step``): the model's ``make_eval_step``, else
        ``train_step(..., train=False)`` (where it takes ``train``) on a
        generator seeded 0."""
        model = self.model
        self.eval_step_fn = None
        if hasattr(model, "make_eval_step"):
            self.eval_step_fn = model.make_eval_step(self.config)
        elif hasattr(model, "train_step"):
            accepts_train = "train" in inspect.signature(model.train_step).parameters
            mixed = is_mixed_precision(self.config)

            @torch.no_grad()
            def eval_step(state, batch):
                generator = torch.Generator(device=self.device).manual_seed(0)
                kwargs = {"train": False} if accepts_train else {}
                with autocast(self.device, mixed):
                    loss, aux = model.train_step(batch, generator, **kwargs)
                return {**{k: v for k, v in aux.items() if k != "outputs"}, "loss": loss}

            self.eval_step_fn = eval_step

    def _checkpoint_state(self) -> Dict:
        """The model's weights and the optimizer states as checkpoint parts."""
        parts = {"model": self.model.module.state_dict(), "optimizer": self.state.state_dict()}
        disc = getattr(self.model, "discriminator", None)
        if disc is not None:
            parts["discriminator"] = disc.state_dict()
        return parts

    def _restore_if_needed(self):
        path = self.args.continue_path or self.args.restore_path
        if not path:
            return
        full_resume = bool(self.args.continue_path)
        ckpt = path
        if os.path.isdir(path):
            names = [
                f for f in os.listdir(path)
                if (f.startswith("checkpoint_") or f.startswith("best_model"))
                and f.endswith(CHECKPOINT_EXT)
            ]
            ckpts = sorted(
                (f for f in names if f.startswith("checkpoint_")),
                key=lambda f: int(f.split("_")[1].split(".")[0]),
            )
            if ckpts:
                ckpt = os.path.join(path, ckpts[-1])
            elif "best_model" + CHECKPOINT_EXT in names:
                ckpt = os.path.join(path, "best_model" + CHECKPOINT_EXT)
            else:
                return
        payload = load_checkpoint_full(ckpt)
        meta = payload.get("meta", {})
        targets = {"model": self.model.module}
        disc = getattr(self.model, "discriminator", None)
        if disc is not None and "discriminator" in payload:
            targets["discriminator"] = disc
        if full_resume:  # exact resume: every tensor must be there
            for key, module in targets.items():
                module.load_state_dict(payload[key], strict=True)
        else:
            # --restore_path transfer learning: copy every tensor whose name
            # exists in the checkpoint with a matching shape, keep the fresh
            # one elsewhere (reference set_init_dict, generic_utils.py:149)
            self.partial_restore = self._partial_merge(
                [(module, payload[key]) for key, module in targets.items()])
        if full_resume:
            if "optimizer" in payload:
                try:
                    self.state.load_state_dict(payload["optimizer"])
                except (KeyError, ValueError) as e:
                    print(f" [!] optimizer state mismatch, restarting optimizer ({e})")
            if "step" in meta:
                self.state.step = int(meta["step"])
                self.global_step = int(meta["step"])
            self.best_loss = float(meta.get("best_loss", float("inf")))
            self.epochs_done = int(meta.get("epochs_done", 0))
        print(
            f" > Restored checkpoint {ckpt} at step {self.global_step}"
            + ("" if full_resume else " (weights only)")
        )

    @staticmethod
    def _partial_merge(pairs) -> tuple:
        """For each ``(module, checkpoint state_dict)``: copy the checkpoint's
        tensors into the module wherever the name exists with a matching
        shape; everything else keeps its fresh value (reference partial
        restore ``set_init_dict``). Returns ``(copied, kept)`` over all the
        modules' tensors, as the JAX package counts its leaves."""
        copied = kept = 0
        with torch.no_grad():
            for module, source in pairs:
                for name, t in module.state_dict().items():
                    src = source.get(name)
                    if src is not None and tuple(src.shape) == tuple(t.shape):
                        t.copy_(src)
                        copied += 1
                    else:
                        kept += 1
        print(f" > Partial restore: {copied} tensors copied, {kept} kept from init")
        return copied, kept

    # ------------------------------------------------------------------
    def get_dataset(self, samples, is_eval: bool = False):
        if hasattr(self.model, "get_dataset"):
            return self.model.get_dataset(self.config, samples, is_eval)
        from tts_tpu_torch.audio.processor import AudioProcessor
        from tts_tpu_torch.data.dataset import TTSDataset

        ap = AudioProcessor.init_from_config(self.config.audio, verbose=False)
        tokenizer = getattr(self.model, "tokenizer", None)
        speaker_manager = getattr(self.model, "speaker_manager", None)
        language_manager = getattr(self.model, "language_manager", None)
        features = {k: getattr(self.config, k, False)
                    for k in ("compute_linear_spec", "return_wav", "compute_f0", "compute_energy")}
        # a model names what its step reads of the host work (VITS: the waveform)
        features.update(getattr(self.model, "dataset_features", {}))
        ds = TTSDataset(
            samples=samples,
            ap=ap,
            outputs_per_step=int(getattr(self.config, "r", 1) or 1),
            tokenizer=tokenizer,
            speaker_id_mapping=speaker_manager.name_to_id if speaker_manager else None,
            language_id_mapping=language_manager.name_to_id if language_manager else None,
            d_vector_mapping=(
                speaker_manager.embeddings
                if speaker_manager and getattr(self.config, "use_d_vector_file", False)
                else None
            ),
            **features,
            min_text_len=getattr(self.config, "min_text_len", 0),
            max_text_len=getattr(self.config, "max_text_len", float("inf")),
            min_audio_len=getattr(self.config, "min_audio_len", 0),
            max_audio_len=getattr(self.config, "max_audio_len", float("inf")),
            # coarser boundaries give fewer distinct shapes
            pad_to_multiple_text=getattr(self.config, "pad_to_multiple_text", 16),
            pad_to_multiple_mel=getattr(self.config, "pad_to_multiple_mel", 32),
        )
        ds.preprocess_samples()
        return ds

    def _sample_weights(self, samples) -> Optional[np.ndarray]:
        """Weighted-sampler weights from the config switches (reference
        ``vits.py:1548 get_sampler``)."""
        from tts_tpu_torch.data.samplers import (
            get_language_balancer_weights,
            get_length_balancer_weights,
            get_speaker_balancer_weights,
        )

        config = self.config
        weights = None
        if getattr(config, "use_language_weighted_sampler", False):
            alpha = getattr(config, "language_weighted_sampler_alpha", 1.0)
            weights = get_language_balancer_weights(samples) * alpha
        if getattr(config, "use_speaker_weighted_sampler", False):
            alpha = getattr(config, "speaker_weighted_sampler_alpha", 1.0)
            w = get_speaker_balancer_weights(samples) * alpha
            weights = w if weights is None else weights + w
        if getattr(config, "use_length_weighted_sampler", False):
            alpha = getattr(config, "length_weighted_sampler_alpha", 1.0)
            w = get_length_balancer_weights(samples) * alpha
            weights = w if weights is None else weights + w
        return weights

    def _format_batch(self, batch: dict) -> dict:
        """The numpy arrays of a batch, mapped by the model's
        ``format_batch``, moved to the device (from pinned host memory
        without blocking on CUDA; token ids as int64), then mapped by its
        ``format_batch_on_device`` (reference ``format_batch_on_device``)."""
        fmt = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        if hasattr(self.model, "format_batch"):
            fmt = self.model.format_batch(fmt)
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in fmt.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k == "text_input":
                t = t.long()
            if cuda:
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        if hasattr(self.model, "format_batch_on_device"):
            out = self.model.format_batch_on_device(out)
        return out

    # ------------------------------------------------------------------
    def fit(self):
        config = self.config
        train_ds = self.get_dataset(self.train_samples)
        eval_ds = self.get_dataset(self.eval_samples, is_eval=True) if self.eval_samples else None
        weights = None
        try:
            weights = self._sample_weights(getattr(train_ds, "samples", self.train_samples))
        except (KeyError, ValueError) as e:
            print(f" [!] weighted sampler disabled: {e}")

        try:
            self._fit_epochs(config, train_ds, eval_ds, weights)
        except KeyboardInterrupt:
            # the reference trainer's graceful stop: persist the whole state
            self.callbacks.on_keyboard_interrupt(self)
            self.save(f"checkpoint_{self.global_step}_interrupted{CHECKPOINT_EXT}")
            print(" > KeyboardInterrupt: saved interrupted-state checkpoint", flush=True)
            self.dashboard.close()
            return self.state
        # the last state; best_model.pth is written only by _track_best, so
        # it always holds the best weights seen
        if self.best_loss == float("inf"):
            self.save("best_model" + CHECKPOINT_EXT, final=True)
        else:
            self.save(f"checkpoint_{self.global_step}{CHECKPOINT_EXT}")
        self.dashboard.close()
        return self.state

    def _fit_epochs(self, config, train_ds, eval_ds, weights):
        for epoch in range(self.epochs_done, config.epochs):
            self.callbacks.on_epoch_start(self)
            if hasattr(self.model, "on_epoch_start") and self.model.on_epoch_start(self):
                # a schedule changed the model's reduction factor (Tacotron's
                # gradual training): the datasets follow it
                new_r = int(getattr(config, "r", 1) or 1)
                for ds in (train_ds, eval_ds):
                    if ds is not None and hasattr(ds, "outputs_per_step"):
                        ds.outputs_per_step = new_r
            if not self.args.skip_train_epoch:
                self._train_epoch(train_ds, epoch, weights)
            self.epochs_done = epoch + 1
            eval_avg = None
            if eval_ds is not None and getattr(config, "run_eval", True):
                eval_avg = self.evaluate(eval_ds)
            self._track_best(eval_avg)
            if epoch >= getattr(config, "test_delay_epochs", 0):
                self.test_run()
            self.callbacks.on_epoch_end(self)
            self.dashboard.flush()

    def _batch_kwargs(self, train_ds, epoch: int, weights) -> dict:
        kwargs = dict(shuffle=True, seed=epoch)
        supported = inspect.signature(train_ds.batches).parameters
        if weights is not None and "weights" in supported:
            kwargs["weights"] = weights
        workers = int(getattr(self.config, "num_loader_workers", 0))
        if workers > 0 and "num_workers" in supported:
            kwargs["num_workers"] = workers
            mode = getattr(self.config, "loader_worker_mode", "thread")
            if mode and "worker_mode" in supported:
                kwargs["worker_mode"] = mode
        return kwargs

    def _train_epoch(self, train_ds, epoch: int, weights: Optional[np.ndarray]):
        config = self.config
        keep_avg = KeepAverage()
        epoch_start = time.time()
        self._last_train_avg = keep_avg
        batches = iter(train_ds.batches(config.batch_size,
                                        **self._batch_kwargs(train_ds, epoch, weights)))
        while True:
            wait_start = time.time()
            batch = next(batches, None)
            if batch is None:
                break
            step_start = time.time()
            self.loader_time = step_start - wait_start
            self.callbacks.on_train_step_start(self)
            batch = self._format_batch(batch)
            self.generator.manual_seed(step_seed(self.seed, self.global_step))
            self.state, metrics = self.train_step_fn(self.state, batch)
            self.global_step += 1
            self.callbacks.on_train_step_end(self)
            if self.global_step % config.print_step == 0:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                host_metrics["step_time"] = time.time() - step_start
                host_metrics["loader_time"] = self.loader_time
                keep_avg.update(host_metrics)
                ms = " - ".join(f"{k}: {v:.4f}" for k, v in sorted(host_metrics.items()))
                print(f" > step {self.global_step}: {ms}", flush=True)
                self.dashboard.add_scalars("train", host_metrics, self.global_step)
            if (
                getattr(config, "save_checkpoints", True)
                and config.save_step > 0
                and self.global_step % config.save_step == 0
            ):
                self.save(f"checkpoint_{self.global_step}{CHECKPOINT_EXT}")
        print(
            f" > epoch {epoch} done in {time.time() - epoch_start:.1f}s "
            f"({self.global_step} steps)",
            flush=True,
        )

    def evaluate(self, eval_ds) -> Optional[float]:
        """The losses without gradient over the WHOLE eval set; returns the
        average ``loss`` (the best model's criterion)."""
        if self.eval_step_fn is None:
            return None
        keep_avg = KeepAverage()
        bs = max(1, getattr(self.config, "eval_batch_size", 8))
        last_batch = None
        for batch in eval_ds.batches(bs, shuffle=False):
            batch = self._format_batch(batch)
            metrics = self.eval_step_fn(self.state, batch)
            keep_avg.update({k: float(v) for k, v in metrics.items()})
            last_batch = batch
        if not keep_avg.avg:
            return None
        if last_batch is not None and hasattr(self.model, "eval_log"):
            try:
                figures, audios = self.model.eval_log(last_batch, self.state)
                if figures:
                    self.dashboard.add_figures("eval", figures, self.global_step)
                if audios:
                    self.dashboard.add_audios(
                        "eval", audios, self.global_step, self.config.audio.sample_rate
                    )
            except Exception as e:  # never kill training on a logging hook
                print(f" [!] eval_log failed: {e}")
        print(
            " > eval: " + " - ".join(f"{k}: {v:.4f}" for k, v in sorted(keep_avg.avg.items())),
            flush=True,
        )
        self.dashboard.add_scalars("eval", keep_avg.avg, self.global_step)
        return keep_avg.avg.get("loss")

    def _track_best(self, eval_avg: Optional[float]):
        """Best-model selection (reference ``save_best_after`` semantics)."""
        config = self.config
        target = eval_avg
        if target is None:
            target = getattr(self, "_last_train_avg", None)
            target = target.avg.get("loss") if target and target.avg else None
        if target is None:
            return
        if target < self.best_loss:
            self.best_loss = float(target)
            if self.global_step >= getattr(config, "save_best_after", 0):
                self.save("best_model" + CHECKPOINT_EXT, final=True)
                if getattr(config, "save_all_best", False):
                    self.save(f"best_model_{self.global_step}{CHECKPOINT_EXT}", final=True)
                print(f" > new best loss {self.best_loss:.4f}", flush=True)

    # ------------------------------------------------------------------
    def test_run(self):
        """Speak ``config.test_sentences`` (the first three) through
        ``utils.synthesis`` and push audio, and figures where matplotlib is
        installed, to the dashboard (reference ``base_tts.py:380
        test_run``). The audio stays in ``last_test_audios``."""
        sentences = getattr(self.config, "test_sentences", None)
        model = self.model
        self.last_test_audios = {}
        if not sentences or not hasattr(model, "inference") or getattr(
                model, "tokenizer", None) is None:
            return
        from tts_tpu_torch.audio.processor import AudioProcessor
        from tts_tpu_torch.utils.synthesis import synthesis
        from tts_tpu_torch.utils.visual import (
            matplotlib_available,
            plot_alignment,
            plot_spectrogram,
        )

        ap = getattr(model, "ap", None) or AudioProcessor.init_from_config(self.config.audio,
                                                                            verbose=False)
        figures_on = matplotlib_available()
        audios, figures = {}, {}
        for i, sent in enumerate(sentences[:3]):
            if isinstance(sent, (list, tuple)):
                sent = sent[0]
            try:
                out = synthesis(model, str(sent), use_griffin_lim=True, ap=ap)
            except Exception as e:  # never kill training on a test sentence
                print(f" [!] test_run failed on sentence {i}: {e}")
                continue
            if out.get("wav") is not None:
                audios[f"test_{i}/audio"] = out["wav"]
            if not figures_on:
                continue
            mo = out.get("model_outputs")
            if mo is not None and np.asarray(mo).ndim == 2 and np.asarray(mo).shape[-1] > 1:
                figures[f"test_{i}/spectrogram"] = plot_spectrogram(mo)
            align = out.get("outputs", {}).get("alignments")
            if align is not None:
                figures[f"test_{i}/alignment"] = plot_alignment(
                    align.float().cpu().numpy() if isinstance(align, torch.Tensor) else align)
        self.last_test_audios = audios
        if audios:
            self.dashboard.add_audios("test", audios, self.global_step, ap.sample_rate)
        if figures:
            self.dashboard.add_figures("test", figures, self.global_step)

    # ------------------------------------------------------------------
    def save(self, filename: str, final: bool = False):
        path = os.path.join(self.output_path, filename)
        save_checkpoint(
            path,
            config=self.config,
            meta={
                "step": self.global_step,
                "best_loss": self.best_loss,
                "epochs_done": self.epochs_done,
            },
            **self._checkpoint_state(),
        )
        print(f" > Saved checkpoint {path}", flush=True)
        # a rewrite of a kept checkpoint (the last state, saved again at the
        # end of fit) is not a new one: the JAX trainer counts it twice and,
        # keeping one checkpoint, prunes the file it just wrote (F53)
        if not final and filename.startswith("checkpoint_") and \
                path not in self._saved_checkpoints:
            self._saved_checkpoints.append(path)
            keep = max(1, int(getattr(self.config, "save_n_checkpoints", 5)))
            while len(self._saved_checkpoints) > keep:
                victim = self._saved_checkpoints.pop(0)
                try:
                    os.remove(victim)
                    print(f" > Pruned old checkpoint {victim}", flush=True)
                except OSError:
                    pass
