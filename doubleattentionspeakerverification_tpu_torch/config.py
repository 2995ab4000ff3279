"""Typed configuration: a copy of the JAX package's ``config.py``.

The same frozen dataclasses, field names and defaults (reference
``scripts/train.py:253-291``; the paper configuration: VGG4L, kernel_size
1024, 32 heads, DoubleMHA, embedding 400, 5994 speakers, Adam at 1e-4), so
a config JSON or a checkpoint's embedded config written by either package
loads in the other field for field. ``from_dict`` skips unknown keys.

Fields that name TPU machinery keep their names and take the port's
meaning: ``use_pallas_pooling`` / ``use_pallas_dsp`` are the tri-state
choices of kernels B1 and B2 on the card (``utils/kernel_auto.py``; None =
auto behind a self-check, resolved where a model is run, so a config keeps
None), ``remat_vgg`` recomputes each VGG block in the backward
(``models/vgg.py``), ``checkpoint_backend = "orbax"`` selects the port's
sharded ``.dcp`` checkpoints (``utils/dist_ckpt.py``), and ``profile_dir``
traces a window of steps with ``torch.profiler`` (``utils/profiling.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class FeatureConfig:
    """Log-mel front-end constants (reference ``scripts/featureExtractor.py:8-23``)."""

    sample_rate: int = 16000
    window_size_s: float = 0.025     # 25 ms -> win_length 400
    window_stride_s: float = 0.010   # 10 ms -> hop 160
    n_fft: int = 512
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None     # None -> sample_rate / 2
    preemphasis: float = 0.97
    rescale: float = 32768.0         # 16-bit scale applied before pre-emphasis
    log_floor: float = 1.0           # log(max(1, mel))

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.window_size_s)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_stride_s)

    @property
    def fmax_hz(self) -> float:
        return self.sample_rate / 2 if self.fmax is None else self.fmax


@dataclass(frozen=True)
class ModelConfig:
    """Network shape (reference ``scripts/train.py:263-275`` defaults +
    ``scripts/model.py:8-71`` assembly)."""

    front_end: str = "VGG4L"              # 'VGG3L' | 'VGG4L'
    kernel_size: int = 1024               # top conv channel count
    embedding_size: int = 400
    heads_number: int = 32
    pooling_method: str = "DoubleMHA"     # 'Attention' | 'MHA' | 'DoubleMHA' | 'StatisticalPooling'
    mask_prob: float = 0.3                # head-dropout; P(drop) = 1 / int(1/mask_prob); <=0 disables
    feature_size: int = 80                # hardcoded in reference (scripts/model.py:13)
    num_spkrs: int = 5994
    # AM-Softmax (scripts/loss.py:5-52)
    scaling_factor: float = 30.0
    margin_factor: float = 0.4
    annealing: bool = False
    # Numerics
    compute_dtype: str = "float32"        # 'float32' | 'bfloat16' for conv/matmul compute
    # B1's and B2's switches (utils/kernel_auto.py; None = auto behind a
    # self-check on the card, resolved where a model is run, so checkpoints
    # keep the tri-state) and the recomputation of each VGG block in the
    # backward (models/vgg.py).
    use_pallas_pooling: Optional[bool] = None
    remat_vgg: bool = False
    use_pallas_dsp: Optional[bool] = None
    # Large-vocabulary classifier: when > 0, the train step computes the
    # AM-Softmax CE by scanning W in chunks of this many classes
    # (ops/chunked_amsoftmax.py) — peak memory (B, chunk) instead of
    # (B, n_spkrs). 0 = dense head. Composes with 'model'-axis sharding.
    classifier_chunk: int = 0
    # Parity toggle: reference scales MHA scores by sqrt(heads_number)
    # because of the d_k=query.size(-1)==heads quirk (scripts/poolings.py:75-76).
    # True  -> divide by sqrt(heads_number)  (reference behavior)
    # False -> divide by sqrt(head_size)     (textbook behavior)
    mha_dk_is_heads: bool = True
    # BatchNorm (torch defaults used by reference nn.BatchNorm1d)
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


@dataclass(frozen=True)
class TrainConfig:
    """Optimization recipe (reference ``scripts/train.py:276-291``)."""

    window_size: float = 3.5              # seconds per training window
    random_slicing: bool = False          # batch-level random truncation (train.py:205-207)
    normalization: str = "cmn"            # 'cmn' | 'cmvn' (data.py:21-30)
    optimizer: str = "Adam"               # 'Adam' | 'SGD' | 'RMSprop'
    # Loss criterion. The reference defines FocalSoftmax (loss.py:54-70) but
    # never instantiates it; here 'focal' is actually selectable.
    criterion: str = "cross_entropy"      # 'cross_entropy' | 'focal'
    focal_gamma: float = 2.0              # gamma of (1-p)^gamma * CE (loss.py:60)
    learning_rate: float = 1e-4
    weight_decay: float = 1e-3
    batch_size: int = 64                  # per optimizer step = batch_size * gradient_accumulation
    gradient_accumulation: int = 2
    # Reference sums (not averages) microbatch gradients: loss.backward() per
    # batch with no division (train.py:219-226). Keep as parity default; set
    # True for the conventional mean.
    grad_accum_mean: bool = False
    max_epochs: int = 1000000
    early_stopping: int = 25
    print_every: int = 1000
    validate_every: int = 10000
    seed: int = 1234
    # LR halved when (stopping+1) % 15 == 0 at epoch end; RMSprop excluded
    # (train.py:90-95,200-203).
    lr_halving_patience: int = 15
    # Checkpointing: reference saves only on best EER (train.py:175-179);
    # we additionally save every `checkpoint_every` steps (0 = off).
    checkpoint_every: int = 0
    keep_checkpoints: int = 3
    # 'npz' (one file per checkpoint, the JAX package's format) or 'orbax':
    # sharded <name>_<step>.dcp directories (utils/dist_ckpt.py), each
    # process writing its own shards; required with more than one process.
    checkpoint_backend: str = "npz"
    # Checkpoints are copied to the host synchronously (the optimizer updates
    # in place) and written by a background thread; best-EER saves block.
    # Kept for the config round trip: npz writes are always asynchronous,
    # .dcp writes (a collective) always synchronous.
    checkpoint_async: bool = True
    # Failure recovery: 0 = the stall watchdog only logs; >0 = after this
    # many seconds without a completed step, dump all thread stacks and
    # _exit(17) so a requeue wrapper (slurm --requeue + --requeue flag here)
    # restarts from the newest checkpoint instead of hanging forever.
    # The clock starts at Trainer CONSTRUCTION (a wedged first device call
    # has been observed there) — library users who construct a Trainer long
    # before calling train() should keep this 0 and rely on the log-only
    # watchdog, or construct right before training.
    stall_exit_s: float = 0.0
    # Graceful preemption: SIGTERM requests a stop; the train loop saves a
    # checkpoint AT the next step boundary, waits for it, and exits 0 so
    # --requeue continues with no lost steps (the reference rolls back to its
    # last best-EER checkpoint, train.py:31-49). Across processes the stop
    # is agreed every preempt_sync_every steps (the OR of every process's
    # flag); one process checks its flag every step.
    preempt_sync_every: int = 10
    # Validation utterances beyond 2x the largest length bucket (160 s):
    # 'chunk' (default) = duration-weighted centroid of largest-bucket
    # chunks; 'pad' = the reference's full-length semantics (train.py:107-133).
    valid_long_audio: str = "chunk"
    # Static promise that every training window is full-length: the step
    # drops its length masks. The loader verifies the promise per batch.
    assume_full_lengths: bool = False
    # Host->device batch dtype: 'float32' (exact); 'bfloat16' halves feature
    # batches; in wav mode any non-float32 value ships the PCM16 samples
    # losslessly as int16.
    transfer_dtype: str = "float32"
    # Batches copied ahead to the device from pinned host memory on a side
    # CUDA stream (training/device_prefetch.py); 0 = a plain copy per step.
    device_prefetch: int = 0
    # A torch.profiler trace of steps [profile_start_step, + profile_steps)
    # under profile_dir (utils/profiling.py); empty = off.
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_steps: int = 5
    # Run EER validation in a background thread over a snapshot of the model
    # taken at the validation step, so the card keeps training (the
    # reference's __validate is serial, train.py:158-184). Decisions are
    # those of serial validation: the best checkpoint saves the snapshot and
    # pending validations are joined at epoch end before LR halving and the
    # early-stop check.
    async_validation: bool = True
    # Across processes each one embeds its shard of the validation
    # utterances and the embeddings are gathered (the same EER everywhere);
    # False: every process embeds them all.
    shard_validation: bool = True
    # After training, time this many steps on a copy of the model and the
    # optimizer over the last batch and log a `step_bench` event: the
    # isolated-step time of this run, against which its loop is read.
    post_step_bench: int = 0
    # SpecAugment (Park et al. 2019) time/frequency masks on the normalized
    # feature windows inside the step; not in the reference (its only
    # augmentation is random slicing, train.py:205-207). Off by default.
    specaugment: bool = False
    specaugment_time_masks: int = 2       # masks per sample over the time axis
    specaugment_time_width: int = 30      # max frames per time mask
    specaugment_freq_masks: int = 2       # masks per sample over the mel axis
    specaugment_freq_width: int = 10      # max mel bins per freq mask


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths and loading (reference ``scripts/train.py:255-262``)."""

    train_data_dir: str = ""
    valid_data_dir: str = ""
    train_labels_path: str = ""
    valid_clients: str = ""
    valid_impostors: str = ""
    # 'features' -> precomputed pickles (reference pipeline parity)
    # 'wav'      -> decode wavs on the host, log-mel on the device
    source: str = "features"
    # wav mode only: compute the log-mel on the HOST (the repo's native C++
    # kernel, numpy without it) and ship feature frames instead of PCM.
    host_dsp: bool = False
    num_workers: int = 2
    prefetch: int = 2
    use_native_loader: bool = True        # C++ wav decoder / prefetcher when built
    # host-RAM budget for caching validation features across validation
    # rounds (they are immutable between rounds; the reference re-reads every
    # utterance from disk twice per trial pair, train.py:117-133). 0 disables.
    valid_feature_cache_mb: float = 512.0
    # Wav mode: compute each utterance's FULL log-mel once on the host and
    # re-window cached frames every epoch — the reference's offline-extract-
    # then-rewindow pipeline (featureExtractor.py:35-43 + data.py:50-55)
    # collapsed into training. Steady-state wav training then costs what
    # feature-mode training costs. RAM LRU budget in MB (0 = off); best when
    # the working set fits — with heavy eviction the full-utterance compute
    # (~2.3x a window) is wasted, so size it or add the disk tier below.
    train_feature_cache_mb: float = 0.0
    # Disk tier for the same cache: reference-format pickles ((n_mels, T)
    # raw float32, byte-compatible with the extractor CLI), so the cache dir
    # is reusable as a --data_source features directory. Empty = off.
    train_feature_cache_dir: str = ""
    # How '--data_source wav' picks its concrete path when neither host_dsp
    # nor a cache budget/dir is set (explicit flags ALWAYS win):
    #   'explicit'  legacy: plain wav means PCM to the device (device DSP)
    #   'auto'      one-shot host probe (cores + free RAM) picks the fastest
    #               mode for this machine; decision is memoized and logged
    #   'pcm' / 'host_dsp' / 'cache'   force that path
    # The train CLI defaults to 'auto' (replaces the reference's manual
    # offline pipeline choice, featureExtractor.py:35-43); the library
    # default stays 'explicit' for backward compatibility.
    wav_mode: str = "explicit"

    def source_mode(self) -> str:
        """The concrete training source path these flags select, decided in
        one place so the loader and the step agree on what the step sees.

        'features'     precomputed pickle features
        'wav_cache'    wav + compute-once host feature cache (step sees features)
        'wav_host_dsp' wav + per-window host DSP (step sees features)
        'wav_pcm'      wav PCM shipped to the device (step runs the DSP)
        """
        if self.source != "wav":
            return "features"
        if self.train_feature_cache_mb > 0 or self.train_feature_cache_dir:
            return "wav_cache"
        if self.host_dsp:
            return "wav_host_dsp"
        mode = self.wav_mode
        if mode == "auto":
            mode = auto_wav_mode()[0]
        if mode in ("pcm", "explicit"):
            return "wav_pcm"
        if mode == "host_dsp":
            return "wav_host_dsp"
        if mode == "cache":
            return "wav_cache"
        raise ValueError(f"unknown wav_mode {self.wav_mode!r}")

    def effective_train_cache_mb(self) -> float:
        """RAM budget the training feature cache actually runs with: the
        explicit flag, or the probe-sized default when 'cache' was chosen
        by name/auto without one."""
        if self.train_feature_cache_mb > 0:
            return self.train_feature_cache_mb
        if self.source_mode() == "wav_cache" and not self.train_feature_cache_dir:
            budget = auto_wav_mode()[1]
            if budget > 0:
                return budget
            # 'cache' forced by NAME on a host whose probe declined it (low
            # free RAM -> probe cache_mb 0): size from local MemAvailable
            # instead of a flat 512 MB, so the RAM-starved host is the one
            # host that does NOT get the big default
            avail_mb = _host_probe()[1]
            return float(min(512.0, max(64.0, avail_mb * 0.2))) if avail_mb > 0 else 64.0
        return 0.0

    def step_sees_waves(self) -> bool:
        """True iff training batches carry raw PCM (the step runs the log-mel,
        kernel B2 on the card)."""
        return self.source_mode() == "wav_pcm"


@functools.lru_cache(maxsize=None)
def _host_probe() -> Tuple[int, float]:
    """(cpu_count, MemAvailable_mb) — memoized so every consumer of the auto
    wav-mode decision (loader, kernel resolver, logs) sees the same facts
    even as free RAM drifts during the run.

    ``DMHA_HOST_PROBE=<cpus>,<avail_mb>`` overrides the measurement — for
    tests that need a deterministic probe (e.g. simulating heterogeneous
    hosts in the 2-process wav-mode scenarios) and for operators who want to
    pin the decision basis regardless of the moment-of-launch RAM reading."""
    override = os.environ.get("DMHA_HOST_PROBE")
    if override:
        c, m = override.split(",")
        return int(c), float(m)
    cpus = os.cpu_count() or 1
    avail_mb = 0.0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail_mb = float(line.split()[1]) / 1024.0
                    break
    except OSError:
        pass
    return cpus, avail_mb


def _auto_wav_mode_from(cpus: int, avail_mb: float) -> Tuple[str, float, str]:
    """Pure decision: (mode, default_cache_mb, reason).

    The JAX package's rule, kept so both packages choose alike on one host:
    a compute-once feature cache when free RAM allows a 256 MB budget;
    otherwise PCM with the log-mel on the device when the host has 8 or more
    cores, else the host DSP.
    """
    cache_mb = min(4096.0, avail_mb * 0.2)
    if cache_mb >= 256.0:
        return (
            "cache",
            float(int(cache_mb)),
            f"{avail_mb:.0f} MB free RAM -> compute-once feature cache "
            f"({int(cache_mb)} MB budget); steady state == feature-mode cost",
        )
    if cpus >= 8:
        return (
            "pcm",
            0.0,
            f"{cpus} host cores, low free RAM -> PCM decode + on-device DSP",
        )
    return (
        "host_dsp",
        0.0,
        f"{cpus} host cores, low free RAM -> native host DSP (compact "
        "feature transfer)",
    )


_AUTO_WAV_MODE_PIN: Optional[Tuple[str, float, str]] = None


def pin_auto_wav_mode(mode: str, cache_mb: float, reason: str) -> None:
    """Override the host-local probe process-wide.

    Multi-host training pins every host to the COORDINATOR's (mode,
    cache budget): the auto decision changes the step input modality and the
    cache behavior, and hosts with heterogeneous cores/RAM must not diverge
    (the budget feeds the deterministic cache-demotion compare in
    ``Trainer._load_data``, so it must be identical everywhere, not just the
    mode). Every consumer — loader, kernel resolver,
    ``effective_train_cache_mb``, logs — reads the pinned value afterwards.
    """
    global _AUTO_WAV_MODE_PIN
    _AUTO_WAV_MODE_PIN = (mode, float(cache_mb), reason)


def auto_wav_mode() -> Tuple[str, float, str]:
    """The memoized auto decision for this host: (mode, cache_mb, reason).
    A coordinator pin (``pin_auto_wav_mode``) takes precedence."""
    if _AUTO_WAV_MODE_PIN is not None:
        return _AUTO_WAV_MODE_PIN
    return _auto_wav_mode_from(*_host_probe())


@dataclass(frozen=True)
class MeshConfig:
    """The ('data', 'model') layout over the processes of a multi-process
    run (``parallel/mesh.py``), one device a process; ``model_axis``
    processes split the AM-Softmax ``W``. One process ignores it."""

    data_axis: int = -1                   # -1 -> all remaining devices
    model_axis: int = 1                   # shards of the speaker classifier W
    data_axis_name: str = "data"
    model_axis_name: str = "model"


@dataclass(frozen=True)
class ExperimentConfig:
    model_name: str = "CNN"
    out_dir: str = "./models/model1"
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------ names
    def describe(self) -> str:
        """Short model name for ``/health``."""
        m = self.model
        return (f"{self.model_name}_{m.front_end}_{m.kernel_size}kernel_"
                f"{m.embedding_size}embSize_{m.pooling_method}_{m.heads_number}")

    def derived_model_name(self) -> str:
        """Mirror of reference ``scripts/utils.py:61-69`` (getModelName)."""
        p = self
        name = p.model_name
        name += "_{}".format(p.model.front_end)
        name += "_{}".format(p.train.window_size)
        name += "_{}batchSize".format(p.train.batch_size * p.train.gradient_accumulation)
        name += "_{}lr".format(p.train.learning_rate)
        name += "_{}weightDecay".format(p.train.weight_decay)
        name += "_{}kernel".format(p.model.kernel_size)
        name += "_{}embSize".format(p.model.embedding_size)
        name += "_{}s".format(p.model.scaling_factor)
        name += "_{}m".format(p.model.margin_factor)
        name += "_{}".format(p.model.pooling_method)
        name += "_{}".format(p.model.heads_number)
        return name

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        continue  # forward-compatible: ignore unknown keys
                    ft = fields[k].type
                    sub = _DATACLASS_BY_NAME.get(ft if isinstance(ft, str) else getattr(ft, "__name__", ""))
                    kwargs[k] = build(sub, v) if sub is not None else v
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)


_DATACLASS_BY_NAME = {
    "FeatureConfig": FeatureConfig,
    "ModelConfig": ModelConfig,
    "TrainConfig": TrainConfig,
    "DataConfig": DataConfig,
    "MeshConfig": MeshConfig,
    "ExperimentConfig": ExperimentConfig,
}


def count_speakers(labels_file_path: str) -> int:
    """Number of distinct labels in a `path label [...]` manifest
    (reference ``scripts/utils.py:53-59``)."""
    speakers = set()
    with open(labels_file_path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                speakers.add(parts[1])
    return len(speakers)
