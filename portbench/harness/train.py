"""The training runner: the port's ``Trainer.train`` loop, built as
``cli/train.py`` builds it, on a seeded WAV corpus.

Set-up makes the corpus (once a checkout), builds the trainer, writes the
seeded weights into its model and wraps its step in a :class:`StepTap`, the
callable the loop calls once a step. The loop's first ``reference_steps``
steps are warm-up, on rows that all differ: the tap keeps their batches,
their losses, the first gradient as Adam took it (from Adam's first moment
after step 1) and the parameters after the last of them. Then it opens the
window at a synchronized step boundary, counts the steps the loop issues
and closes it, synchronized again, at the first step boundary past
``--seconds``, ending the loop. The reference then follows those first
steps from the same weights and batches.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from . import arith, common, reference, traffic
from .trace import Profiler, reduce


class WindowClosed(Exception):
    """Raised by the tap to end the trainer's loop once the window closed."""


class StepTap:
    """Stands in the trainer's ``train_step`` and calls the real one."""

    def __init__(self, inner, optimizer, device, n_ref: int, seconds: float, trace: bool):
        self.inner, self.optimizer, self.device = inner, optimizer, device
        self.n_ref, self.seconds, self.trace = n_ref, seconds, trace
        self.calls = 0
        self.batches: List[Dict] = []
        self.losses: List = []
        self.grad1 = self.params_after = None
        self.t0 = self.t1 = None
        self.window_steps = 0
        self.dispatch_s = self.wait_s = 0.0
        self.last_return = None
        self.nonfinite = None
        self.launch0 = self.launch1 = None
        self.setup_peak = self.window_peak = 0
        self.profiler = None
        self.trace_path = None

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize()

    def _launches(self):
        from doubleattentionspeakerverification_tpu_torch import ops

        return {k.name: k.launches for k in ops.KERNELS}

    def _open(self):
        import torch

        model = self.inner.model
        self.params_after = {n: p.detach().clone() for n, p in model.named_parameters()}
        self._sync()
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.nonfinite = torch.zeros((), dtype=torch.int32, device=self.device)
        self.launch0 = self._launches()
        if self.trace:
            self.profiler = Profiler(self.device.type == "cuda")
            self.profiler.start()
        self.t0 = time.perf_counter()
        self.wall0 = time.time()

    def _close(self):
        import torch

        self._sync()
        self.t1 = time.perf_counter()
        if self.profiler is not None:
            self.trace_path = self.profiler.stop()
        self.launch1 = self._launches()
        if self.device.type == "cuda":
            self.window_peak = torch.cuda.max_memory_allocated()

    def __call__(self, batch, keep=None):
        k = self.calls
        self.calls += 1
        now = time.perf_counter()
        if k == self.n_ref:
            self._open()
            now = self.t0
        elif k > self.n_ref:
            self.wait_s += now - self.last_return
            if now - self.t0 >= self.seconds:
                self._close()
                raise WindowClosed()
        if k < self.n_ref:
            self.batches.append({n: v.detach().clone() for n, v in batch.items()})
        t = time.perf_counter()
        out = self.inner(batch, keep)
        if k >= self.n_ref:
            self.dispatch_s += time.perf_counter() - t
            self.window_steps += 1
            self.nonfinite += (~out["loss"].isfinite()).to(self.nonfinite.dtype)
        else:
            self.losses.append(out["loss"].detach().clone())
        if k == 0:
            beta1 = self.optimizer.param_groups[0]["betas"][0]
            self.grad1 = {n: self.optimizer.state[p]["exp_avg"].detach() / (1.0 - beta1)
                          for n, p in self.inner.model.named_parameters()}
        self.last_return = time.perf_counter()
        return out


def _reference_batches(batches, spec, classes, cache, mode):
    """The reference's own inputs for the kept batches, and the count of rows
    that are not a window of an utterance of their label (the loader's crops
    are the one stage the reference takes as drawn). A PCM row is looked up
    in its corpus file; a feature row in the reference's own normalization
    of its corpus file, bit for bit, and the reference then takes its own
    window."""
    import torch

    root, _ = traffic.ensure_corpus(cache, spec, classes)
    by_label: Dict[int, List[str]] = {}
    for name, label, _ in traffic.corpus_files(spec, classes):
        by_label.setdefault(label, []).append(name)
    features = spec.get("format") == "features"
    key = "inputs" if features else "waves"
    misses, out = 0, []
    for b in batches:
        rows = b[key].cpu().numpy()
        shape = rows.shape
        rows = rows.reshape((-1,) + shape[2:])
        own = np.array(rows)
        labels = b["labels"].cpu().numpy().reshape(-1)
        lengths = b["lengths"].cpu().numpy().reshape(-1)
        for r, (row, label, n) in enumerate(zip(rows, labels, lengths)):
            found = False
            for name in by_label.get(int(label), []):
                if features:
                    utt = reference.normalize_np(
                        traffic.read_features(os.path.join(root, name + ".pickle")), mode)
                    heads = np.flatnonzero((utt == row[0]).all(1))
                else:
                    utt = traffic.read_pcm(os.path.join(root, name + ".wav"))
                    view = np.lib.stride_tricks.sliding_window_view(utt, 8)
                    heads = np.flatnonzero((view == row[:8]).all(1))
                for off in heads:
                    if off + n <= len(utt) and np.array_equal(utt[off:off + n], row[:n]):
                        own[r, :n] = utt[off:off + n]
                        found = True
                        break
                if found:
                    break
            misses += not found
        out.append({key: torch.from_numpy(own.reshape(shape)).to(b[key].device),
                    "lengths": b["lengths"], "labels": b["labels"]})
    return misses, out


def _norm(t) -> float:
    return float(t.double().norm())


def leaf_gaps(prog: Dict, ref: Dict, names: List[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    ref_n = {n: _norm(ref[n]) for n in names}
    med = statistics.median(ref_n.values())
    return {n: abs(_norm(prog[n]) - ref_n[n]) / max(ref_n[n], med, 1e-30) for n in names}


def _worst(gaps: Dict[str, float]) -> str:
    return ", ".join(f"{n} {v:.3g}" for n, v in sorted(gaps.items(), key=lambda x: -x[1])[:3])


def compare(prog: Dict, ref: Dict, p0: Dict) -> Dict[str, float]:
    """Every number the comparison can take, each a gap between the
    program's reading and the reference's: the first step's loss and the
    worst step's (relative), the first gradient as Adam took it and the
    parameters' change after the steps, each by the worst leaf. The change
    leaves out leaves whose reference gradient is under a thousandth of the
    median leaf's. Which of them are held to a limit is the cell's limits
    file's to say."""
    names = list(ref["grad1"])
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    raw = {n: _norm(ref["raw1"][n]) for n in names}
    med = statistics.median(raw.values())
    moved = [n for n in names if raw[n] >= 1e-3 * med]
    change_p = {n: prog["params"][n] - p0[n] for n in moved}
    change_r = {n: ref["params"][n] - p0[n] for n in moved}
    grad = leaf_gaps(prog["grad1"], ref["grad1"], names)
    change = leaf_gaps(change_p, change_r, moved)
    common.log(f"[train] loss gaps by step {losses}; worst leaves: gradient {_worst(grad)}; "
               f"change {_worst(change)}; left out of the change: "
               f"{sorted(set(names) - set(moved))}")
    return {"loss_gap": losses[0], "loss_gap_any_step": max(losses),
            "grad_gap": max(grad.values()), "change_gap": max(change.values())}


def run(args, cell: common.Cell, t_start: float) -> common.Outcome:
    import torch

    from doubleattentionspeakerverification_tpu_torch.cli import train as cli
    from doubleattentionspeakerverification_tpu_torch.training.trainer import Trainer
    from doubleattentionspeakerverification_tpu_torch.utils.logging import MetricLogger

    conf, spec = cell.config, cell.traffic
    device = torch.device("cpu" if args.cpu_smoke else "cuda")
    cache = common.SMOKE_CACHE if args.cpu_smoke else common.CACHE
    front = reference.FrontEnd("cpu")
    corpus, manifest = traffic.ensure_corpus(
        cache, spec["corpus"], conf["num_spkrs"],
        lambda pcm: front.log_mel(torch.from_numpy(pcm[None]))[0].float().numpy())
    out_dir = tempfile.mkdtemp(prefix="portbench-train-")
    parser = cli.make_parser()
    argv = common.cli_argv(parser, conf) + spec["trainer_argv"] + [
        "--train_data_dir", corpus, "--train_labels_path", manifest, "--out_dir", out_dir,
        "--seed", str(args.seed), "--device", device.type]
    with contextlib.redirect_stdout(sys.stderr):
        cfg = cli.build_config(parser.parse_args(argv))
    if cfg.model.num_spkrs != conf["num_spkrs"]:
        raise RuntimeError(f"the corpus holds {cfg.model.num_spkrs} speakers, "
                           f"not {conf['num_spkrs']}")
    logger = MetricLogger(stream=sys.stderr)
    trainer = Trainer(cfg, logger=logger, device=device.type)
    p0 = common.fill_weights(trainer.model, args.seed, device)
    tap = StepTap(trainer.train_step, trainer.optimizer, device, spec["reference_steps"],
                  args.seconds, bool(args.trace))
    trainer.train_step = tap
    try:
        trainer.train()
    except WindowClosed:
        pass
    finally:
        trainer.close()
        logger.close()
    if tap.t1 is None:
        raise RuntimeError("the training loop ended before the window closed")
    window_s = tap.t1 - tap.t0
    steps = tap.window_steps
    rows = conf["batch_size"] * conf["gradientAccumulation"]
    e2e = {"setup_s": tap.wall0 - t_start,
           "train_audio_s_per_s": steps * rows * conf["window_size"] / window_s}
    nonfinite = int(tap.nonfinite)
    frames = int(round(conf["window_size"] * 100))
    common.log(f"[train] window {window_s:.3f} s, {steps} steps, "
               f"{e2e['train_audio_s_per_s']:.1f} audio-s/s, setup {e2e['setup_s']:.2f} s, "
               f"{arith.train_step_flops(conf, frames) / 1e12:.4f} TFLOP a step")

    prog = {"losses": [float(x) for x in tap.losses],
            "grad1": {n: g.to(device) for n, g in tap.grad1.items()},
            "params": tap.params_after}
    batches = tap.batches
    checks = {}
    limits = cell.limits
    summary = None
    if tap.trace_path:
        summary = reduce(tap.trace_path, common.load_json(common.HERE, "kernel_classes.json"))
    if device.type == "cuda":
        # every step launches the kernels its traffic names, as often as it says
        for name, per_step in spec["kernels_per_step"].items():
            got = tap.launch1[name] - tap.launch0[name]
            checks[f"{name}_launch_gap"] = (float(abs(got - per_step * steps)), 0.0)
    view = common.RunView("train", conf, spec, window_s, summary, counters={
        "steps": steps, "loader_wait_s": tap.wait_s, "dispatch_s": tap.dispatch_s,
        "window_peak_bytes": tap.window_peak, "frames": frames})
    peak = max(tap.setup_peak, tap.window_peak)
    del trainer, tap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    misses, batches = _reference_batches(batches, spec["corpus"], conf["num_spkrs"], cache,
                                         conf["normalization"])
    checks["crop_misses"] = (float(misses), 0.0)
    # the reference keeps TF32 off, as the configuration states
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    front = reference.FrontEnd(device)
    t = time.perf_counter()
    ref = reference.train_steps(p0, batches, args.seed, conf,
                                reference.PRECISIONS[conf["compute_dtype"]], front,
                                spec["reference_steps"])
    common.log(f"[train] reference: {spec['reference_steps']} steps in "
               f"{time.perf_counter() - t:.2f} s; losses {ref['losses']} "
               f"program {prog['losses']}")
    numbers = compare(prog, ref, p0)
    common.log(f"[train] numbers: {numbers}")
    if args.control:
        # the control stands in the program's place: its steps are the ones judged
        low = reference.CONTROL_OF[conf["compute_dtype"]]
        numbers = compare(reference.train_steps(p0, batches, args.seed, conf,
                                                reference.PRECISIONS[low], front,
                                                spec["reference_steps"]), ref, p0)
        common.log(f"[train] control ({low}) in the program's place: {numbers}")
    for k, lim in limits.items():
        checks[k] = (numbers[k], lim)
    checks["nonfinite_losses"] = (float(nonfinite), 0.0)
    return common.Outcome(attempted=steps, failed=nonfinite, e2e=e2e, view=view, checks=checks,
                          memory_peak_bytes=peak)
