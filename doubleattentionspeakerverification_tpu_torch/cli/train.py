"""Training CLI (JAX ``cli/train.py``; reference ``scripts/train.py:251-305``).

The JAX package's parser, with its flag names and defaults, plus
``--device`` (``cuda`` by default; ``cpu`` where asked). The config is
written to ``{out_dir}/{model_name}_config.json`` and the events to
``{out_dir}/{model_name}_metrics.jsonl``. SIGTERM asks the trainer for a
graceful stop (a checkpoint at the next step boundary, exit 0; ``--requeue``
continues from it), SIGUSR1 dumps every thread's stack.

``--use_pallas_dsp`` / ``--use_pallas_pooling`` choose kernels B2 and B1
(``--no-...``: their plain versions) on the card; without them the kernel
dispatcher runs each behind a one-time self-check (``utils/kernel_auto.py``).
``--profile_dir`` traces steps ``[--profile_start_step, +
--profile_steps)`` with ``torch.profiler`` (``utils/profiling.py``);
``--tensorboard_dir`` writes every logged number as a TensorBoard scalar
(``utils/tensorboard.py``).

Multi-process training (``--distributed``; implied by
``--coordinator_address`` or ``JAX_COORDINATOR_ADDRESS``): every process
runs this command with the same flags; ``parallel.distributed.initialize``
joins them (the coordinator from the flags, the JAX package's variables or
torchrun's), each on its own device. ``--checkpoint_backend orbax`` writes
the sharded ``.dcp`` directories and is required; ``--model_parallel``
splits the AM-Softmax ``W`` over that many processes. Process 0 writes the
config and the one JSONL stream. On two cards of one machine::

    torchrun --nproc_per_node 2 -m doubleattentionspeakerverification_tpu_torch.cli.train \
        --distributed --checkpoint_backend orbax ...
"""

from __future__ import annotations

import argparse
import os
import sys

from ..config import (
    DataConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    count_speakers,
)
from ..training.trainer import Trainer, refuse_unported
from ..utils.logging import MetricLogger


def build_config(params: argparse.Namespace) -> ExperimentConfig:
    num_spkrs = count_speakers(params.train_labels_path)
    print(f"{num_spkrs} Speaker Labels")
    cfg = ExperimentConfig(
        model_name=params.model_name,
        out_dir=params.out_dir,
        model=ModelConfig(
            front_end=params.front_end,
            kernel_size=params.kernel_size,
            embedding_size=params.embedding_size,
            heads_number=params.heads_number,
            pooling_method=params.pooling_method,
            mask_prob=params.mask_prob,
            num_spkrs=num_spkrs,
            scaling_factor=params.scalingFactor,
            margin_factor=params.marginFactor,
            annealing=params.annealing,
            compute_dtype=params.compute_dtype,
            use_pallas_dsp=params.use_pallas_dsp,
            use_pallas_pooling=params.use_pallas_pooling,
            classifier_chunk=params.classifier_chunk,
        ),
        train=TrainConfig(
            window_size=params.window_size,
            random_slicing=params.randomSlicing,
            normalization=params.normalization,
            optimizer=params.optimizer,
            criterion=params.criterion,
            focal_gamma=params.focal_gamma,
            learning_rate=params.learning_rate,
            weight_decay=params.weight_decay,
            batch_size=params.batch_size,
            gradient_accumulation=params.gradientAccumulation,
            max_epochs=params.max_epochs,
            early_stopping=params.early_stopping,
            print_every=params.print_every,
            validate_every=params.validate_every,
            checkpoint_every=params.checkpoint_every,
            checkpoint_backend=params.checkpoint_backend,
            checkpoint_async=params.checkpoint_async,
            preempt_sync_every=params.preempt_sync_every,
            valid_long_audio=params.valid_long_audio,
            seed=params.seed,
            transfer_dtype=params.transfer_dtype,
            device_prefetch=params.device_prefetch,
            stall_exit_s=params.stall_exit_s,
            assume_full_lengths=params.assume_full_lengths,
            profile_dir=params.profile_dir,
            profile_start_step=params.profile_start_step,
            profile_steps=params.profile_steps,
            async_validation=not params.sync_validation,
            shard_validation=params.shard_validation,
            post_step_bench=params.post_step_bench,
            specaugment=params.specaugment,
            specaugment_time_masks=params.specaugment_time_masks,
            specaugment_time_width=params.specaugment_time_width,
            specaugment_freq_masks=params.specaugment_freq_masks,
            specaugment_freq_width=params.specaugment_freq_width,
        ),
        data=DataConfig(
            train_data_dir=params.train_data_dir,
            valid_data_dir=params.valid_data_dir,
            train_labels_path=params.train_labels_path,
            valid_clients=params.valid_clients,
            valid_impostors=params.valid_impostors,
            source=params.data_source,
            host_dsp=params.host_dsp,
            wav_mode=params.wav_mode,
            num_workers=params.num_workers,
            valid_feature_cache_mb=params.valid_feature_cache_mb,
            train_feature_cache_mb=params.feature_cache_mb,
            train_feature_cache_dir=params.feature_cache_dir,
        ),
        mesh=MeshConfig(model_axis=params.model_parallel),
    )
    return cfg


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train a VGG + attention-pooling speaker embedding extractor "
                    "(PyTorch + CUDA port)."
    )
    parser.add_argument("--train_data_dir", type=str, default="")
    parser.add_argument("--valid_data_dir", type=str, default="")
    parser.add_argument("--train_labels_path", type=str, default="labels/Vox2.ndx")
    parser.add_argument("--valid_clients", type=str, default="labels/clients.ndx")
    parser.add_argument("--valid_impostors", type=str, default="labels/impostors.ndx")
    parser.add_argument("--out_dir", type=str, default="./models/model1")
    parser.add_argument("--model_name", type=str, default="CNN")
    parser.add_argument("--front_end", type=str, default="VGG4L", choices=["VGG3L", "VGG4L"])
    # network
    parser.add_argument("--window_size", type=float, default=3.5)
    parser.add_argument("--randomSlicing", action="store_true")
    parser.add_argument("--normalization", type=str, default="cmn", choices=["cmn", "cmvn"])
    parser.add_argument("--kernel_size", type=int, default=1024)
    parser.add_argument("--embedding_size", type=int, default=400)
    parser.add_argument("--heads_number", type=int, default=32)
    parser.add_argument("--pooling_method", type=str, default="DoubleMHA",
                        choices=["Attention", "MHA", "DoubleMHA", "StatisticalPooling"])
    parser.add_argument("--mask_prob", type=float, default=0.3)
    # AM-Softmax
    parser.add_argument("--scalingFactor", type=float, default=30.0)
    parser.add_argument("--marginFactor", type=float, default=0.4)
    parser.add_argument("--annealing", action="store_true")
    # optimization
    parser.add_argument("--optimizer", type=str, default="Adam", choices=["Adam", "SGD", "RMSprop"])
    parser.add_argument("--criterion", type=str, default="cross_entropy",
                        choices=["cross_entropy", "focal"],
                        help="loss criterion; 'focal' activates the reference's "
                             "dead FocalSoftmax semantics (loss.py:54-70)")
    parser.add_argument("--focal_gamma", type=float, default=2.0)
    # Parsed-but-unused in the reference (train.py:258); accepted here so
    # reference invocations are drop-in.
    parser.add_argument("--data_mode", type=str, default="normal")
    parser.add_argument("--learning_rate", type=float, default=0.0001)
    parser.add_argument("--weight_decay", type=float, default=0.001)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--gradientAccumulation", type=int, default=2)
    parser.add_argument("--max_epochs", type=int, default=1000000)
    parser.add_argument("--early_stopping", type=int, default=25)
    parser.add_argument("--print_every", type=int, default=1000)
    parser.add_argument("--requeue", action="store_true")
    parser.add_argument("--resume_step", type=int, default=None,
                        help="resume from the checkpoint at this exact "
                             "optimizer step instead of the newest")
    parser.add_argument("--validate_every", type=int, default=10000)
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--valid_feature_cache_mb", type=float, default=512.0,
                        help="host RAM budget for caching validation features "
                             "across validation rounds (0 disables)")
    # extensions of the JAX package
    parser.add_argument("--data_source", type=str, default="features", choices=["features", "wav"],
                        help="'features': reference-format pickles; 'wav': on-device log-mel")
    parser.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="shards of the AM-Softmax classifier over the mesh 'model' axis")
    parser.add_argument("--feature_cache_mb", type=float, default=0.0,
                        help="wav mode: RAM budget (MB) for the compute-once "
                        "full-utterance feature cache; steady-state epochs then "
                        "re-window cached frames like the reference's offline-"
                        "features pipeline (0 = recompute DSP every window)")
    parser.add_argument("--feature_cache_dir", type=str, default="",
                        help="wav mode: disk tier for the feature cache — "
                        "reference-format pickles, reusable as a features dir")
    parser.add_argument("--host_dsp", action="store_true",
                        help="wav mode: compute log-mel on the host (fused native C++ "
                             "kernel when built) and ship bf16/f32 feature frames instead "
                             "of PCM — ~2x fewer host->device bytes")
    parser.add_argument("--wav_mode", type=str, default="auto",
                        choices=["auto", "pcm", "host_dsp", "cache", "explicit"],
                        help="wav mode selection when neither --host_dsp nor a "
                             "--feature_cache_* flag is given (those always win): "
                             "'auto' probes this host (cores + free RAM) and picks "
                             "the fastest path, logging the decision; or force "
                             "'pcm' / 'host_dsp' / 'cache'")
    parser.add_argument("--use_pallas_dsp", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="on the card: the log-mel as kernel B2 (--use_pallas_dsp) or "
                        "its plain version (--no-use_pallas_dsp); default: B2 behind a "
                        "one-time self-check")
    parser.add_argument("--use_pallas_pooling", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="on the card: the MHA pooling as kernel B1 or its plain "
                        "version (--no-use_pallas_pooling); default: B1 behind a "
                        "one-time self-check")
    parser.add_argument("--classifier_chunk", type=int, default=0,
                        help=">0: scan the AM-Softmax W in class chunks of this size "
                             "(memory-bounded CE for very large speaker counts)")
    parser.add_argument("--checkpoint_every", type=int, default=0)
    parser.add_argument("--checkpoint_backend", type=str, default="npz",
                        choices=["npz", "orbax"],
                        help="'orbax' writes sharded <name>_<step>.dcp "
                             "directories (each process writes its own shards); "
                             "required with more than one process")
    parser.add_argument("--checkpoint_async", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="npz: periodic saves block only for the "
                             "device->host copy, best-EER saves until written "
                             "(the .dcp backend always writes synchronously)")
    parser.add_argument("--valid_long_audio", type=str, default="chunk",
                        choices=["chunk", "pad"],
                        help="validation utterances beyond 2x the largest "
                             "bucket: 'chunk' = centroid of largest-bucket "
                             "chunks; 'pad' = the reference's full-length "
                             "semantics")
    parser.add_argument("--preempt_sync_every", type=int, default=10,
                        help="multi-process: agree on a SIGTERM graceful-stop "
                             "verdict every N steps (one tiny collective); "
                             "one process checks its flag every step")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--stall_exit_s", type=float, default=0.0,
                        help="exit(17) after this many seconds without a "
                             "completed step (0=log only); pair with "
                             "--requeue under a restarting scheduler")
    parser.add_argument("--device_prefetch", type=int, default=0,
                        help="batches copied ahead to the device from pinned "
                             "memory on a side CUDA stream (0 = a plain copy "
                             "per step)")
    parser.add_argument("--transfer_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16", "int16"],
                        help="host->device batch payload dtype (bfloat16 for "
                             "features / int16 for wavs halves transfer bytes)")
    parser.add_argument("--tensorboard_dir", type=str, default="",
                        help="also write metrics as TensorBoard scalar event "
                             "files here (dependency-free writer)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace (Chrome/Perfetto "
                             "JSON) of a window of training steps here")
    parser.add_argument("--profile_start_step", type=int, default=10,
                        help="first optimizer step of the trace window "
                             "(default 10: past compile + warmup)")
    parser.add_argument("--profile_steps", type=int, default=5,
                        help="number of steps to trace")
    parser.add_argument("--assume_full_lengths", action="store_true",
                        help="all training windows are full-length: the step drops "
                             "its length masks")
    parser.add_argument("--post_step_bench", type=int, default=0,
                        help="after training, time N steps on a copy of the model "
                             "over the last batch and log this run's "
                             "isolated-step ms (step_bench event)")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process training: join the process group "
                             "before building the trainer. The coordinator and "
                             "topology come from the flags below, the env vars "
                             "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                             "JAX_PROCESS_ID, or torchrun's MASTER_ADDR / "
                             "MASTER_PORT / WORLD_SIZE / RANK. Implied when "
                             "JAX_COORDINATOR_ADDRESS is set. Requires "
                             "--checkpoint_backend orbax")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 (or file:///path for "
                             "processes on one machine)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--shard_validation", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="multi-host: partition the validation utterance "
                             "set across processes (each host embeds only its "
                             "shard; embeddings all-gathered; identical EER "
                             "everywhere). --no-shard_validation = every host "
                             "embeds the full set. Ignored single-host")
    parser.add_argument("--sync_validation", action="store_true",
                        help="run EER validation serially (reference behavior); "
                        "default overlaps it with training in a background "
                        "thread over a params snapshot")
    parser.add_argument("--specaugment", action="store_true",
                        help="SpecAugment time/frequency masking on the feature "
                             "windows inside the train step (not in the "
                             "reference; off by default)")
    parser.add_argument("--specaugment_time_masks", type=int, default=2)
    parser.add_argument("--specaugment_time_width", type=int, default=30)
    parser.add_argument("--specaugment_freq_masks", type=int, default=2)
    parser.add_argument("--specaugment_freq_width", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the port trains: the card (default) or the CPU")
    return parser


def main(argv=None) -> int:
    # SIGUSR1 dumps all thread stacks to stderr (pairs with the stall
    # watchdog: a hung run can be inspected without killing it)
    import faulthandler
    import signal

    try:
        faulthandler.enable()
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except Exception:
        pass

    params = make_parser().parse_args(argv)
    refused = []
    cfg = build_config(params)
    try:
        refuse_unported(cfg)
    except ValueError as e:
        refused.append(str(e))
    # several processes: join them before the trainer's first device use
    host_id, device = 0, params.device
    if not refused and (params.distributed or params.coordinator_address
                        or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        from ..parallel.distributed import initialize

        try:
            info = initialize(params.coordinator_address, params.num_processes,
                              params.process_id, force=params.distributed, device=params.device)
        except ValueError as e:
            refused.append(str(e))
        else:
            host_id, device = info.host_id, info.device
    if refused:
        for msg in refused:
            print(f"error: {msg}", file=sys.stderr)
        return 2

    os.makedirs(cfg.out_dir, exist_ok=True)
    name = cfg.derived_model_name()
    if host_id == 0:
        with open(os.path.join(cfg.out_dir, f"{name}_config.json"), "w") as f:
            f.write(cfg.to_json())
    # one console and JSONL stream a run: the other processes train the same
    # global step and would repeat every event
    quiet = None if host_id == 0 else open(os.devnull, "w")
    logger = (MetricLogger(jsonl_path=os.path.join(cfg.out_dir, f"{name}_metrics.jsonl"),
                           tensorboard_dir=params.tensorboard_dir or None)
              if quiet is None else MetricLogger(stream=quiet))
    # SIGTERM (a scheduler's preemption notice) asks for a checkpoint at the
    # next step boundary and a clean exit; installed before construction so
    # a signal then is not lost. SIGINT keeps its default.
    stop_box: dict = {}

    def _on_sigterm(signum, frame):
        t = stop_box.get("trainer")
        if t is not None:
            t.request_stop("SIGTERM")
        else:
            stop_box["early"] = True

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        pass  # not the main thread

    try:
        trainer = Trainer(cfg, logger=logger, device=device)
        stop_box["trainer"] = trainer
        if stop_box.get("early"):
            trainer.request_stop("SIGTERM (during construction)")
        if params.resume_step is not None:
            if not trainer.resume(step=params.resume_step):
                print(f"no checkpoint at step {params.resume_step} in {cfg.out_dir}")
                return 1
        elif params.requeue:
            trainer.resume()
        trainer.train()
    finally:
        if stop_box.get("trainer") is not None:
            stop_box["trainer"].close()     # its watchdog must not outlive the run
        logger.close()
        if quiet is not None:
            quiet.close()
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
