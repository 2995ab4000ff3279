"""Training orchestration (JAX ``training/trainer.py``; reference
``Trainer``, ``scripts/train.py:19-235``).

Control flow kept from the reference: epoch loop, periodic loss/accuracy
prints, EER validation every ``validate_every`` optimizer steps, best-EER
checkpointing and early stopping, LR halving after ``lr_halving_patience``
stagnant validations at epoch end (Adam/SGD only, ``train.py:90-95``), and
requeue-style resume. Kept from the JAX package: periodic checkpoints in
its ``.npz`` format (each package resumes from the other's files),
mid-epoch resume, graceful preemption (``request_stop``), validation in a
background thread, the stall watchdog, and the loader's (seed, epoch, step,
row)-keyed batch stream.

On the card: the step is ``training/step.py`` (kernel B2 in wav-PCM mode,
kernel B1 forward and backward in every step), validation forwards run on
a second, eval-mode copy of the model on a side CUDA stream, ordered after
the step by an event, and the loss and accuracy are summed on the device
with one host read per print window.

Across processes (``parallel/``; after ``parallel.distributed.initialize``
the trainer takes the process group's rank and size): one device a
process, the ('data', 'model') layout of ``cfg.mesh`` over them, each
process's loader assembling its rows of the global batch, the AM-Softmax
``W`` split over the model ranks, and, as in the JAX package: checkpoints
in the sharded ``.dcp`` backend (``checkpoint_backend="orbax"``, which more
than one process requires; ``utils/dist_ckpt.py``), serial validation, each
process embedding its shard of the utterances (``shard_validation``), the
coordinator's auto wav-mode verdict and cache demotion broadcast, and a
graceful stop agreed every ``preempt_sync_every`` steps as the OR of every
process's flag. Validation needs no gather of ``W``: the embedding stops
at ``b2``, and every other parameter is whole on every process. One
process ignores ``mesh`` (JAX on one device makes no mesh either).

Under ``checkpoint_async`` (the default) periodic ``.dcp`` saves are
written by ``utils/dist_ckpt.py:DcpAsyncSaver`` and finalized at the next
save, a graceful stop, the end of ``train()`` or :meth:`Trainer.close`,
which also stops the stall watchdog; the CLI closes its trainer however
the run ends.

``profile_dir`` traces optimizer steps ``[profile_start_step,
+ profile_steps)`` with ``torch.profiler`` (``utils/profiling.py``), logging
``profile_started`` and ``profile_stopped`` as the JAX trainer does; the
capture closes after the window's last step's device work.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from functools import partial
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ExperimentConfig
from ..data.dataset import FeaturePickleSource, TrainLoader, WavSource
from ..data.manifest import load_train_manifest, load_trials
from ..evaluation.embeddings import (
    EmbeddingExtractor,
    FeatureCache,
    pickle_feature_loader,
    validate_eer,
)
from ..models.classifier import SpeakerClassifier
from ..models.init import init_parameters
from ..parallel.distributed import all_gather_np, broadcast_np
from ..parallel.mesh import host_batch_rows, make_mesh, shard_columns, shard_model
from ..utils.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    load_checkpoint,
    prune_checkpoints,
)
from ..utils.device import resolve_device
from ..utils.kernel_auto import resolve_dsp
from ..utils.logging import MetricLogger
from ..utils.profiling import StepProfiler
from ..utils.weights import load_train_state, optimizer_state_by_name, train_state_to_jax
from .device_prefetch import device_prefetch
from .optimizers import get_lr, make_optimizer, with_lr
from .step import TrainStep, make_train_step


def refuse_unported(cfg: ExperimentConfig) -> None:
    """Settings of the JAX trainer that the port does not carry out raise
    here rather than being ignored."""
    if cfg.train.checkpoint_backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint_backend {cfg.train.checkpoint_backend!r}")


class TrainSnapshot(NamedTuple):
    """The train state at one step: the model's state dict, the optimizer's
    state by parameter name, the step and the learning rate."""

    model_state: Dict[str, torch.Tensor]
    opt_state: Dict[str, Dict[str, torch.Tensor]]
    step: int
    lr: float


def _host_copy(snap: TrainSnapshot, device: torch.device) -> TrainSnapshot:
    """The snapshot copied to the host: on the card into pinned buffers, all
    copies queued on the training stream and then one wait for that stream
    (not the device: a validation in flight on its own stream runs on); on
    the CPU, clones."""
    def copy(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.device.type == "cpu":
            return t.detach().clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t.detach(), non_blocking=True)

    host = TrainSnapshot({k: copy(v) for k, v in snap.model_state.items()},
                         {n: {k: copy(v) for k, v in st.items()} for n, st in snap.opt_state.items()},
                         snap.step, snap.lr)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return host


class Trainer:
    def __init__(self, cfg: ExperimentConfig, logger: Optional[MetricLogger] = None,
                 device="cuda"):
        refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.log = logger or MetricLogger()
        self.model_name = cfg.derived_model_name()
        live = dist.is_initialized()
        self.host_id = dist.get_rank() if live else 0
        self.num_hosts = dist.get_world_size() if live else 1
        if self.num_hosts > 1 and cfg.train.checkpoint_backend != "orbax":
            # npz gathers every leaf into one file on one process
            raise ValueError(
                "multi-host training requires checkpoint_backend='orbax' "
                "(npz checkpoints host-gather; pass --checkpoint_backend orbax)"
            )
        # the clock starts at construction: a wedged first device call
        # shows too; a constructor that raises stops it again
        self._failed = False
        self._dcp_saver = None
        self._watchdog = self._make_watchdog().start()
        try:
            self._wav_mode_requested = cfg.data.wav_mode
            if self.num_hosts > 1 and cfg.data.source == "wav" and cfg.data.wav_mode == "auto":
                self.cfg = cfg = self._pin_wav_mode(cfg)

            self.mesh = None
            self._local_rows = None
            if self.num_hosts > 1:
                data_size = self.num_hosts // max(1, cfg.mesh.model_axis)
                if cfg.train.batch_size % max(1, data_size):
                    raise ValueError(
                        f"batch_size {cfg.train.batch_size} not divisible by the mesh data axis "
                        f"({data_size}) — required for multi-host training")
                self.mesh = make_mesh(cfg.mesh)
                self._local_rows = host_batch_rows(self.mesh, cfg.train.batch_size)
            self._columns = shard_columns(cfg.model.num_spkrs, self.mesh)
            if cfg.train.checkpoint_backend == "orbax" and cfg.train.checkpoint_async:
                from ..utils.dist_ckpt import DcpAsyncSaver

                # its gloo group is made after the mesh's, in the same order
                # on every process
                self._dcp_saver = DcpAsyncSaver()
            model = init_parameters(SpeakerClassifier(cfg.model),
                                    torch.Generator().manual_seed(cfg.train.seed))
            self.model = shard_model(model, self.mesh).to(self.device)
            self.optimizer = make_optimizer(cfg.train, self.model.parameters())
            # the learning rate is held as float32, as optax holds it
            with_lr(self.optimizer, float(np.float32(cfg.train.learning_rate)))
            self.train_step: TrainStep = make_train_step(cfg, self.model, self.optimizer,
                                                         self.device, mesh=self.mesh)
            self._val_model: Optional[SpeakerClassifier] = None
            self._val_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

            self._load_data()

            self.best_eer = 50.0
            self.stopping = 0
            self.starting_epoch = 0
            self.epoch = 0
            self.best_ckpt_path: Optional[str] = None
            self._print_t0 = time.time()
            self._pause_s = 0.0
            self._valid_loader = None
            self._pending_val = None  # (thread, result_box, snapshot, epoch)
            self._checkpointer = AsyncCheckpointer()
            self._stop_requested = False  # set by request_stop (signal handler)
            self._stop_reason = ""
            self.preempted = False  # train() exited via a graceful stop
            self._resume_skip_steps = 0  # mid-epoch resume: in-epoch steps done
            self._dispatch_hint_logged = False
            if os.environ.get("DMHA_REQUEUE"):
                self.resume()
        except BaseException:
            self._failed = True
            self.close()
            raise

    @property
    def step(self) -> int:
        """Optimizer steps taken (the JAX ``TrainState.step``)."""
        return self.train_step.step

    def _pin_wav_mode(self, cfg: ExperimentConfig) -> ExperimentConfig:
        """Every process takes process 0's auto wav-mode verdict, mode and
        cache budget both: the mode decides the step's input and the budget
        the cache demotion, and processes on unlike hosts must not
        diverge."""
        import dataclasses

        from ..config import auto_wav_mode, pin_auto_wav_mode

        modes = ("pcm", "host_dsp", "cache")
        local_mode, local_mb, _ = auto_wav_mode()
        decision = broadcast_np(np.asarray([modes.index(local_mode), local_mb], np.float64))
        mode, cache_mb = modes[int(decision[0])], float(decision[1])
        pin_auto_wav_mode(mode, cache_mb, f"coordinator broadcast: process 0 chose '{mode}' "
                                          f"({cache_mb:.0f} MB cache budget)")
        return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, wav_mode=mode))

    # ------------------------------------------------------------------ data
    def _load_data(self) -> None:
        from ..utils.native import native_available

        cfg = self.cfg
        manifest = load_train_manifest(cfg.data.train_labels_path)
        window_frames = int(cfg.train.window_size * 100)
        mode = cfg.data.source_mode()
        requested_auto = self._wav_mode_requested == "auto"
        reason = None
        if (mode == "wav_cache" and requested_auto and cfg.data.train_feature_cache_mb <= 0
                and not cfg.data.train_feature_cache_dir):
            # the probe sized the cache without seeing the corpus: if the
            # feature working set clearly exceeds the budget, the LRU would
            # recompute full utterances per window, so demote to host DSP
            # (both modes feed the step features)
            from ..data.feature_cache import estimate_feature_working_set_mb

            budget_mb = cfg.data.effective_train_cache_mb()
            est_mb = estimate_feature_working_set_mb(cfg.data.train_data_dir,
                                                     [u.path for u in manifest])
            demote = est_mb > 1.2 * budget_mb
            if self.num_hosts > 1:
                # the estimate stats each host's files: take process 0's verdict
                demote = bool(broadcast_np(np.asarray([demote], np.int32))[0])
            if demote:
                mode = "wav_host_dsp"
                reason = (f"auto cache demoted to host DSP: estimated feature "
                          f"working set {est_mb:.0f} MB vs {budget_mb:.0f} MB budget "
                          "(LRU thrash would recompute full utterances per window)")
        # validation extracts its features with the DSP training resolved to
        self._resolved_source_mode = mode
        if cfg.data.source == "wav":
            from ..config import auto_wav_mode

            if reason is None:
                reason = auto_wav_mode()[2] if requested_auto else "explicit flags"
            self.log.log(
                "source_mode",
                mode=mode,
                wav_mode=cfg.data.wav_mode,
                cache_mb=cfg.data.effective_train_cache_mb() if mode == "wav_cache" else 0.0,
                reason=reason,
                # the native and the python paths draw different windows
                native=bool(native_available()),
            )
        if mode == "wav_cache":
            from ..data.feature_cache import CachedDspWavSource

            source = CachedDspWavSource(
                cfg.data.train_data_dir, cfg.features, window_frames, cfg.train.normalization,
                cache_mb=cfg.data.effective_train_cache_mb(),
                cache_dir=cfg.data.train_feature_cache_dir,
            )
            is_wave = False
        elif mode == "wav_host_dsp":
            from ..data.dataset import HostDspWavSource

            source = HostDspWavSource(cfg.data.train_data_dir, cfg.features, window_frames,
                                      cfg.train.normalization)
            is_wave = False
        elif mode == "wav_pcm":
            source = WavSource(cfg.data.train_data_dir, cfg.features, window_frames,
                               native_reader=self._native_reader())
            is_wave = True
        else:
            source = FeaturePickleSource(cfg.data.train_data_dir, cfg.train.normalization,
                                         window_frames)
            is_wave = False
        self.loader = TrainLoader(manifest, source, cfg.train, cfg.data,
                                  feature_dim=cfg.model.feature_size, is_wave=is_wave,
                                  host_id=self.host_id, num_hosts=self.num_hosts,
                                  local_rows=self._local_rows)

    def _native_reader(self):
        if not self.cfg.data.use_native_loader:
            return None
        from ..utils.native import native_available, native_read_wav

        return native_read_wav if native_available() else None

    # -------------------------------------------------------------- validate
    def _valid_feature_loader(self):
        """Validation features, cached across rounds (the model changes
        between rounds, the features on disk do not)."""
        if self._valid_loader is not None:
            return self._valid_loader
        cfg = self.cfg
        if cfg.data.source == "wav":
            from ..evaluation.embeddings import wav_feature_loader

            host_dsp = cfg.data.host_dsp or self._resolved_source_mode in (
                "wav_host_dsp", "wav_cache")
            use_kernel = resolve_dsp(cfg.model.use_pallas_dsp, cfg.features,
                                     need_dsp=not host_dsp, device=self.device)
            loader = wav_feature_loader(cfg.data.valid_data_dir, cfg.features,
                                        cfg.train.normalization, host_dsp=host_dsp,
                                        device=self.device, use_kernel=use_kernel)
            self.log.log("valid_loader", host_dsp=bool(host_dsp),
                         train_mode=self._resolved_source_mode)
        else:
            loader = pickle_feature_loader(cfg.data.valid_data_dir, cfg.train.normalization)
        if cfg.data.valid_feature_cache_mb > 0:
            loader = FeatureCache(loader, cfg.data.valid_feature_cache_mb)
        self._valid_loader = loader
        return loader

    def validate(self, model: Optional[torch.nn.Module] = None,
                 stream: Optional["torch.cuda.Stream"] = None) -> Dict[str, float]:
        """EER of ``model`` (the training model by default) on the
        validation trials."""
        cfg = self.cfg
        t0 = time.time()
        extractor = EmbeddingExtractor(
            self.model if model is None else model, self._valid_feature_loader(),
            num_workers=max(1, cfg.data.num_workers), long_audio=cfg.train.valid_long_audio,
            stream=stream,
        )
        clients = load_trials(cfg.data.valid_clients)
        impostors = load_trials(cfg.data.valid_impostors)
        if self.num_hosts > 1 and cfg.train.shard_validation:
            # each process embeds its shard; the gathered cache is the whole
            # one, so every process computes the same EER (a collective:
            # validation is serial across processes and runs at one step)
            from ..evaluation.embeddings import sharded_extract

            utts = [u for pair in (*clients, *impostors) for u in pair]
            n_local = sharded_extract(extractor, utts, self.host_id, self.num_hosts)
            self.log.log("validate_shard", n_total=len(set(utts)), n_local=n_local,
                         n_embedded=extractor.n_embedded)
        result = validate_eer(extractor, clients, impostors)
        result["elapsed_s"] = time.time() - t0
        return result

    def _apply_validation(self, result: Dict[str, float], snap: TrainSnapshot,
                          epoch: int) -> None:
        """Record a finished validation: improvement bookkeeping and the
        best-EER checkpoint of the state AT the validation step."""
        eer = result["eer"]
        self.log.log("validate", epoch=epoch, step=snap.step, eer=eer,
                     eer_exact=result["eer_exact"], elapsed_s=result["elapsed_s"])
        if eer < self.best_eer:
            self.best_eer = eer
            self.stopping = 0
            self.best_ckpt_path = self._save("best", snap=snap, epoch=epoch)
            # best checkpoints are the requeue target: block until written
            self._checkpointer.wait()
            self.log.log("new_best", eer=eer, path=self.best_ckpt_path)
        else:
            self.stopping += 1
            self.log.log("no_improvement", best_eer=self.best_eer, stopping=self.stopping)

    def _join_validation(self) -> None:
        """Wait for the background validation (if any) and apply it."""
        if self._pending_val is None:
            return
        th, box, snap, epoch = self._pending_val
        self._pending_val = None
        t_pause = time.time()
        th.join()
        if "error" in box:
            raise box["error"]
        self._apply_validation(box["result"], snap, epoch)
        # time blocked on the join is left out of the throughput window
        self._pause_s += time.time() - t_pause

    def _snapshot(self, clone: bool) -> TrainSnapshot:
        """The live state; with ``clone`` its optimizer state is copied on
        the device (the model is copied into the validation model)."""
        opt = optimizer_state_by_name(self.model, self.optimizer)
        if clone:
            opt = {n: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
                   for n, st in opt.items()}
        return TrainSnapshot(self.model.state_dict(), opt, self.step, get_lr(self.optimizer))

    def _async_validation_enabled(self) -> bool:
        # across processes a second thread issuing collectives beside the
        # training thread could order them differently on each process
        return self.cfg.train.async_validation and self.num_hosts == 1

    def _on_validation(self) -> None:
        if not self._async_validation_enabled():
            t_pause = time.time()
            result = self.validate()
            self._apply_validation(result, self._snapshot(clone=False), self.epoch)
            self._pause_s += time.time() - t_pause
            return
        # one validation in flight at a time (reference cadence)
        self._join_validation()
        if self._val_model is None:
            self._val_model = SpeakerClassifier(self.cfg.model).to(self.device).eval()
        # copies queued on the training stream after this step's update and
        # before the next one's, so the update in place cannot race them
        self._val_model.load_state_dict(self.model.state_dict())
        snap = self._snapshot(clone=True)._replace(model_state=self._val_model.state_dict())
        ready = None
        if self._val_stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        box: Dict = {}

        def run() -> None:
            try:
                if ready is not None:
                    self._val_stream.wait_event(ready)
                box["result"] = self.validate(self._val_model, stream=self._val_stream)
            except BaseException as e:  # surfaced in the training thread
                box["error"] = e

        th = threading.Thread(target=run, name="validation", daemon=True)
        self._pending_val = (th, box, snap, self.epoch)
        th.start()

    # ------------------------------------------------------------ checkpoint
    def _meta(self, snap: TrainSnapshot, epoch: Optional[int] = None) -> Dict:
        return {
            "config": self.cfg.to_dict(),
            "model_name": self.model_name,
            "epoch": self.epoch if epoch is None else epoch,
            "step": snap.step,
            "best_eer": self.best_eer,
            "stopping": self.stopping,
            "lr": float(np.float32(snap.lr)),
            "best_ckpt_path": self.best_ckpt_path,
            # a mid-epoch resume is valid only for unchanged epoch geometry
            "steps_per_epoch": self.loader.steps_per_epoch(),
        }

    def _save(self, kind: str = "periodic", snap: Optional[TrainSnapshot] = None,
              epoch: Optional[int] = None) -> str:
        """Queue a checkpoint of ``snap`` (the live state by default). The
        host copy is made here. npz: the JAX layout, the write and, for
        periodic files, the pruning run on the checkpointer's thread. .dcp
        under ``checkpoint_async``: periodic saves are written by DCP's
        thread and finalized at the next ``wait()``, best saves block (JAX
        ``training/trainer.py:524-538``); otherwise every process writes its
        shards before this returns."""
        t0 = time.perf_counter()
        snap = self._snapshot(clone=False) if snap is None else snap
        os.makedirs(self.cfg.out_dir, exist_ok=True)
        stem = (f"{self.model_name}_best_{snap.step}" if kind == "best"
                else f"{self.model_name}_{snap.step}")
        dcp = self.cfg.train.checkpoint_backend == "orbax"
        path = os.path.join(self.cfg.out_dir, stem + (".dcp" if dcp else ".npz"))
        meta = self._meta(snap, epoch)
        if kind == "best":
            # a resume from it must restore best_ckpt_path so pruning keeps
            # protecting it
            meta["best_ckpt_path"] = path
        host = _host_copy(snap, self.device)
        leaves = partial(train_state_to_jax, host.model_state, host.opt_state,
                         self.cfg.train.optimizer, host.step, host.lr)
        keep = self.cfg.train.keep_checkpoints
        if dcp:
            # every process writes its shards: a collective
            from ..utils.dist_ckpt import prune_dcp_checkpoints, save_checkpoint_dcp

            if self._dcp_saver is not None:
                self._dcp_saver.save(path, leaves(), meta, columns=self._columns,
                                     block=kind == "best")
            else:
                save_checkpoint_dcp(path, leaves(), meta, columns=self._columns)
            self.log.log("ckpt_save", kind=kind, backend="dcp", step=snap.step,
                         mode="sync" if self._dcp_saver is None else "async",
                         blocked_s=round(time.perf_counter() - t0, 4))
            # the save in flight has no meta.json yet and is the newest: the
            # pruning neither counts nor removes it
            if kind != "best" and keep > 0:
                prune_dcp_checkpoints(self.cfg.out_dir, self.model_name, keep,
                                      (self.best_ckpt_path,) if self.best_ckpt_path else ())
            return path
        then = None
        if kind != "best" and keep > 0:
            protect = (self.best_ckpt_path,) if self.best_ckpt_path else ()
            then = partial(prune_checkpoints, self.cfg.out_dir, self.model_name, keep, protect)
        self._checkpointer.save(path, leaves, meta, then=then)
        self.log.log("ckpt_save", kind=kind, backend="npz", step=snap.step, mode="async",
                     blocked_s=round(time.perf_counter() - t0, 4))
        return path

    # ------------------------------------------------------------ preemption
    def request_stop(self, reason: str = "signal") -> None:
        """Request a graceful stop (the SIGTERM handler's entry): the train
        loop checkpoints at the next step boundary and returns. Safe from
        signal handlers and threads (a bool and a str store)."""
        self._stop_reason = reason
        self._stop_requested = True

    def _preempt_verdict(self, step: int) -> bool:
        """Do the processes agree to stop at this step boundary? One
        process: its own flag, every step. Several: only one may have been
        signalled, so the verdict is the OR of every process's flag, agreed
        every ``preempt_sync_every`` steps (every process calls it at every
        step, so the agreement is reached at the same step everywhere)."""
        if self.num_hosts == 1:
            return self._stop_requested
        every = self.cfg.train.preempt_sync_every
        if every <= 0 or step % every:
            return False
        return bool(all_gather_np(np.asarray([int(self._stop_requested)], np.int32)).max() > 0)

    def _graceful_stop(self, step: int) -> None:
        """Join any validation in flight (a best save must land first), save
        a checkpoint AT the interrupt step and wait for it: the process exits
        right after, and --requeue must find it."""
        self.log.log("preempt_stop", step=step,
                     reason=self._stop_reason or "peer-host signal")
        self._join_validation()
        path = self._save("periodic")
        self._wait_for_saves()
        self.preempted = True
        self.log.log("preempt_checkpoint", path=path, step=step)

    def resume(self, step: Optional[int] = None) -> bool:
        """Requeue-style resume (reference ``train.py:31-49``): the newest
        checkpoint, or the one at optimizer ``step``. Reads either package's
        files."""
        dcp = self.cfg.train.checkpoint_backend == "orbax"
        if step is not None:
            path = self._find_step_checkpoint(step, ".dcp" if dcp else ".npz")
        elif dcp:
            from ..utils.dist_ckpt import latest_dcp_checkpoint

            path = latest_dcp_checkpoint(self.cfg.out_dir)
        else:
            path = latest_checkpoint(self.cfg.out_dir)
        if path is None:
            return False
        # the whole state; this model rank takes its columns of W
        flat, meta = load_checkpoint(path)
        self.train_step.step = load_train_state(flat, self.model, self.optimizer,
                                                self.cfg.train.optimizer, self._columns)
        ckpt_epoch = int(meta.get("epoch", 0))
        self.best_eer = float(meta.get("best_eer", 50.0))
        self.stopping = int(meta.get("stopping", 0))
        self.best_ckpt_path = meta.get("best_ckpt_path") or self.best_ckpt_path
        # A mid-epoch checkpoint resumes INSIDE its epoch: the loader's
        # streams are keyed by (seed, epoch, step), so skipping the consumed
        # steps continues the uninterrupted stream. At an epoch boundary, or
        # when the epoch geometry changed, start the next epoch.
        steps_per_epoch = self.loader.steps_per_epoch()
        ckpt_spe = meta.get("steps_per_epoch")
        in_epoch = self.step - ckpt_epoch * max(1, steps_per_epoch)
        if ckpt_spe == steps_per_epoch and 0 < in_epoch < steps_per_epoch:
            self.starting_epoch = ckpt_epoch
            self._resume_skip_steps = in_epoch
        else:
            if ckpt_spe is not None and ckpt_spe != steps_per_epoch and 0 < in_epoch:
                self.log.log("resume_geometry_changed", ckpt_steps_per_epoch=ckpt_spe,
                             steps_per_epoch=steps_per_epoch,
                             note="mid-epoch offset invalid; restarting at epoch+1")
            self.starting_epoch = ckpt_epoch + 1
            self._resume_skip_steps = 0
        self.log.log("resume", path=path, step=self.step, epoch=self.starting_epoch,
                     in_epoch_skip=self._resume_skip_steps)
        return True

    def _find_step_checkpoint(self, step: int, suffix: str = ".npz") -> Optional[str]:
        if not os.path.isdir(self.cfg.out_dir):
            return None
        for fname in sorted(os.listdir(self.cfg.out_dir)):
            if fname.endswith(f"_{step}{suffix}") and fname.startswith(self.model_name):
                return os.path.join(self.cfg.out_dir, fname)
        return None

    # ----------------------------------------------------------------- train
    def _halve_lr_if_stagnant(self) -> None:
        """Epoch-end LR halving (``train.py:200-203``): every
        ``lr_halving_patience`` non-improving validations; RMSprop excluded."""
        if (self.stopping + 1) % self.cfg.train.lr_halving_patience == 0:
            if self.cfg.train.optimizer in ("Adam", "SGD"):
                new_lr = float(np.float32(get_lr(self.optimizer) * 0.5))
                with_lr(self.optimizer, new_lr)
                self.log.log("lr_halved", lr=new_lr)

    def _make_watchdog(self):
        from ..utils.watchdog import Watchdog

        cfg = self.cfg
        stall_since = {"step": None, "t0": 0.0}

        def on_stall(age: float, last: int) -> None:
            # the watchdog resets its beat after each report, so accumulate
            # no-progress time per stuck step here
            now = time.monotonic()
            if stall_since["step"] != last:
                stall_since["step"] = last
                stall_since["t0"] = now - age
            total = now - stall_since["t0"]
            self.log.log("stall", age_s=round(total, 1), last_step=last)
            if cfg.train.stall_exit_s > 0 and total >= cfg.train.stall_exit_s:
                import faulthandler
                import sys as _sys

                self.log.log("stall_exit", age_s=round(total, 1), last_step=last)
                try:  # stacks of every thread, for the post-mortem
                    faulthandler.dump_traceback(file=_sys.stderr, all_threads=True)
                except Exception:
                    pass
                os._exit(17)  # a wedged device call cannot be unwound cleanly

        return Watchdog(
            timeout_s=min(600.0, cfg.train.stall_exit_s) if cfg.train.stall_exit_s > 0 else 600.0,
            on_stall=on_stall,
        )

    def _wait_for_saves(self) -> None:
        """Every checkpoint written, the ``.dcp`` one in flight finalized."""
        self._checkpointer.wait()
        if self._dcp_saver is not None:
            self._dcp_saver.wait()

    def close(self) -> None:
        """Stop the stall watchdog; idempotent. After a clean run the
        ``.dcp`` save in flight is finalized first (a collective). After a
        failure (a ``train()`` or a constructor that raised) no collective
        runs: that save stays without its marker, invisible to ``latest``
        and removed by a later prune, as a crash leaves it (JAX's crash
        semantics). The JAX trainer has no such method, and its watchdog
        outlives a trainer that never trains (``training/trainer.py:73``)."""
        if self._dcp_saver is not None and not self._failed:
            self._dcp_saver.wait()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    def train(self) -> None:
        """The training loop; one that raises closes the trainer first."""
        try:
            self._train()
        except BaseException:
            self._failed = True
            self.close()
            raise

    def _train(self) -> None:
        cfg = self.cfg
        self._print_t0 = time.time()
        self._pause_s = 0.0
        watchdog = self._watchdog
        if watchdog is None:  # a second train() on this instance
            watchdog = self._watchdog = self._make_watchdog().start()
        watchdog.beat(-1)  # construction survived; the loop beats from here

        self.log.log("start_training", model=self.model_name,
                     steps_per_epoch=self.loader.steps_per_epoch())
        # metrics stay on the device between prints: one host read per window
        metric_sum = torch.zeros(2, dtype=torch.float32, device=self.device)
        metric_n = 0
        step = self.step
        last_batch = None
        last_metrics = None
        profiler = StepProfiler(cfg.train.profile_dir, cfg.train.profile_start_step,
                                cfg.train.profile_steps)
        wait_s = dispatch_s = 0.0  # host-side accounting per print window

        for self.epoch in range(self.starting_epoch, cfg.train.max_epochs):
            # mid-epoch resume: skip the in-epoch steps the checkpoint holds
            skip = self._resume_skip_steps if self.epoch == self.starting_epoch else 0
            epoch_batches = self.loader.epoch(self.epoch, start_step=skip)
            batches_it = iter(device_prefetch(epoch_batches, depth=cfg.train.device_prefetch,
                                              device=self.device))
            while True:
                t_w = time.perf_counter()
                batch = next(batches_it, None)
                wait_s += time.perf_counter() - t_w
                if batch is None:
                    break
                last_batch = batch
                evt = profiler.before_step(
                    step, sync=None if last_metrics is None else last_metrics["loss"])
                if evt:
                    self.log.log(f"profile_{evt}", step=step, dir=cfg.train.profile_dir)
                t_d = time.perf_counter()
                metrics = last_metrics = self.train_step(batch)
                dispatch_s += time.perf_counter() - t_d
                metric_sum += torch.stack((metrics["loss"], metrics["accuracy"])).detach()
                metric_n += 1
                step += 1
                watchdog.beat(step)

                if step % cfg.train.print_every == 0:
                    window_loss, window_acc = metric_sum.tolist()  # ONE host read
                    window_n = metric_n
                    metric_sum.zero_()
                    metric_n = 0
                    elapsed = time.time() - self._print_t0 - self._pause_s
                    samples = window_n * cfg.train.batch_size * cfg.train.gradient_accumulation
                    self.log.log(
                        "train",
                        epoch=self.epoch,
                        step=step,
                        xent=window_loss / max(1, window_n),
                        accuracy=100.0 * window_acc / max(1, window_n),
                        audio_s_per_s=samples * cfg.train.window_size / max(1e-9, elapsed),
                        elapsed_min=elapsed / 60,
                        # where the window's host time went: blocked on the
                        # loader vs issuing the step
                        loader_wait_s=round(wait_s, 3),
                        dispatch_s=round(dispatch_s, 3),
                    )
                    if (not self._dispatch_hint_logged and cfg.train.device_prefetch == 0
                            and window_n >= 5 and dispatch_s / window_n > 0.02):
                        self._dispatch_hint_logged = True
                        self.log.log(
                            "perf_hint",
                            dispatch_ms_per_step=round(1e3 * dispatch_s / window_n, 1),
                            hint="step dispatch is paying the batch transfer "
                            "synchronously; consider --device_prefetch 2",
                        )
                    wait_s = dispatch_s = 0.0
                    self._print_t0 = time.time()
                    self._pause_s = 0.0

                if cfg.train.validate_every and step % cfg.train.validate_every == 0:
                    self._on_validation()

                if cfg.train.checkpoint_every and step % cfg.train.checkpoint_every == 0:
                    self._save("periodic")

                # called at every step: across processes the verdict is an
                # agreement that every process enters at the same step
                if self._preempt_verdict(step):
                    self._graceful_stop(step)
                    break

            if self.preempted:
                getattr(batches_it, "close", lambda: None)()
                break
            # epoch-end decisions see every validation launched this epoch
            self._join_validation()
            if cfg.train.early_stopping >= 0 and self.stopping > cfg.train.early_stopping:
                self.log.log("early_stop", best_eer=self.best_eer)
                break
            self._halve_lr_if_stagnant()
        if profiler.active:  # the run ended inside the window
            profiler.close(sync=None if last_metrics is None else last_metrics["loss"])
            self.log.log("profile_stopped", step=step, dir=cfg.train.profile_dir)
        self._join_validation()
        self._wait_for_saves()
        if cfg.train.post_step_bench > 0 and last_batch is not None:
            self._post_step_bench(last_batch, cfg.train.post_step_bench, watchdog)
        watchdog.stop()
        self._watchdog = None
        self.log.log("finished", best_eer=self.best_eer)

    def _post_step_bench(self, batch, n: int, watchdog=None) -> None:
        """The isolated-step time of this run: ``n`` steps on copies of the
        model and the optimizer over the last batch, already on the device
        (no loader, no transfer), timed with CUDA events on the card. The
        trainer's own state is untouched."""
        model = copy.deepcopy(self.model)
        opt = make_optimizer(self.cfg.train, model.parameters())
        # load_state_dict keeps the state's tensors: copy them first
        opt.load_state_dict(copy.deepcopy(self.optimizer.state_dict()))
        bench = TrainStep(self.cfg, model, opt, self.device, torch.Generator(), self.mesh)
        bench.step = self.step
        bench(batch)  # warm
        n = max(1, n)
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                bench(batch)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / n
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                bench(batch)
            ms = (time.perf_counter() - t0) / n * 1e3
        if watchdog is not None:
            watchdog.beat(-2)  # bench progress counts as liveness
        self.log.log("step_bench", ms_per_step=round(ms, 2), steps=n)
