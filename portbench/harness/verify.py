"""The serving runner: ``/verify`` through the port's HTTP server
(``serving.make_server``) under an open loop from a load-generator process.

Set-up starts the load generator (which builds its upload pool meanwhile),
builds the model with the seeded weights, starts the server with the
traffic's batching settings, runs one forward for every (rows, bucket)
shape the pool can form, and enrolls every speaker through ``/enroll``.
The window is the generator's schedule; each request is timed from when it
was due until its response was read, and the run waits for every answer
(up to ``drain_s``). Then a sample of the answered requests, drawn from the
seed with the longest among them, is scored again by the reference from the
same uploads and enrollments.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np

from . import arith, common, reference, traffic
from .trace import Profiler, reduce


def _model(conf: Dict, seed: int, device):
    """The embedding model at ``conf`` with the seeded weights, as the
    serving CLI builds it from a checkpoint."""
    from doubleattentionspeakerverification_tpu_torch.api import SpeakerEmbeddingModel, empty_model
    from doubleattentionspeakerverification_tpu_torch.cli import train as cli

    labels = os.path.join(tempfile.mkdtemp(prefix="portbench-verify-"), "labels.ndx")
    with open(labels, "w") as f:
        f.writelines(f"s{i} {i}\n" for i in range(conf["num_spkrs"]))
    parser = cli.make_parser()
    with contextlib.redirect_stdout(sys.stderr):
        cfg = cli.build_config(parser.parse_args(
            common.cli_argv(parser, conf) + ["--train_labels_path", labels]))
    model = empty_model(cfg).to(device)
    p0 = common.fill_weights(model, seed, device)
    return SpeakerEmbeddingModel(model, cfg, normalization=conf["normalization"],
                                 device=device.type), p0


class LoadGen:
    def __init__(self, spec: Dict, seed: int):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loadgen.py")
        self.proc = subprocess.Popen([sys.executable, path, "--traffic", json.dumps(spec),
                                      "--seed", str(seed)],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def read(self) -> Dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load generator ended (exit {self.proc.wait()})")
        return json.loads(line)

    def ask(self, **cmd) -> Dict:
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()
        return self.read()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps({"cmd": "quit"}) + "\n")
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def run(args, cell: common.Cell, t_start: float) -> common.Outcome:
    import torch

    from doubleattentionspeakerverification_tpu_torch import ops
    from doubleattentionspeakerverification_tpu_torch.evaluation.embeddings import bucket_for
    from doubleattentionspeakerverification_tpu_torch.serving import SERVE_BUCKETS, make_server

    conf, spec = cell.config, cell.traffic
    device = torch.device("cpu" if args.cpu_smoke else "cuda")
    gen = LoadGen(spec, args.seed)
    server = None
    try:
        sem, p0 = _model(conf, args.seed, device)
        server = make_server(sem, "127.0.0.1", 0, **spec["server"])
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        ready = gen.read()
        samples = ready["samples"]
        common.log(f"[verify] pool of {len(samples)} uploads built in {ready['build_s']:.2f} s")
        buckets = sorted({bucket_for(arith.frames_of(n), SERVE_BUCKETS) for n in samples})
        for b in buckets:
            for rows in range(1, spec["server"]["max_batch"] + 1):
                sem.embed_features(torch.zeros((rows, b, 80), device=device), [b] * rows)
        enrolled = gen.ask(cmd="enroll", port=port)
        if enrolled["enrolled"] != enrolled["attempted"]:
            raise RuntimeError(f"enrollment failed: {enrolled}")
        if device.type == "cuda":
            torch.cuda.synchronize()
        stats0 = server.batcher.stats()
        launch0 = {k.name: k.launches for k in ops.KERNELS}
        prof = Profiler(device.type == "cuda") if args.trace else None
        if prof:
            prof.start()
        win = gen.ask(cmd="window", port=port, seconds=args.seconds)
        if device.type == "cuda":
            torch.cuda.synchronize()
        trace_path = prof.stop() if prof else None
        stats1 = server.batcher.stats()
        launch1 = {k.name: k.launches for k in ops.KERNELS}
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            server.batcher.close()
        gen.close()
    recs = win["records"]
    ok = [r for r in recs if r[3] == 200]
    lat = [1e3 * (r[2] - r[0]) for r in ok]
    last_done = max(r[2] for r in recs)
    e2e = {"setup_s": win["wall0"] - t_start}
    if lat:
        e2e.update(verify_p95_ms=_percentile(lat, 95), verify_p50_ms=_percentile(lat, 50))
    common.log(f"[verify] generator lateness p99 {win['lateness_p99_ms']:.3f} ms, "
               f"largest {win['lateness_max_ms']:.3f} ms; {len(recs)} requests, "
               f"{len(ok)} answered 200, last answer at {last_done:.3f} s; {e2e}")
    forwards = stats1["forwards"] - stats0["forwards"]
    requests = [{"samples": samples[r[6]], "status": r[3]} for r in recs]
    summary = None
    if trace_path:
        summary = reduce(trace_path, common.load_json(common.HERE, "kernel_classes.json"))
    view = common.RunView("verify", conf, spec, last_done, summary, counters={
        "forwards": forwards, "batched_requests": stats1["requests"] - stats0["requests"]},
        requests=requests)
    # no answer at all, or an answer other than a score or a shed (503)
    checks = {"unanswered": (float(sum(r[3] == -1 for r in recs)), 0.0),
              "wrong_status": (float(sum(r[3] not in (-1, 200, 503) for r in recs)), 0.0)}
    if device.type == "cuda":
        b2 = launch1["logmel"] - launch0["logmel"]
        checks["b2_launch_gap"] = (float(max(0, len(ok) - b2) + max(0, b2 - len(recs))), 0.0)
        checks["b1_launch_gap"] = (float(abs(launch1["mha_pool"] - launch0["mha_pool"]
                                             - forwards)), 0.0)
    del sem, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference: a sample of the answered requests, the longest among them
    rng = np.random.default_rng((args.seed, 4))
    longest = max(range(len(ok)), key=lambda i: samples[ok[i][6]])
    pick = {longest} | set(rng.choice(len(ok), min(len(ok), spec["check_sample"]) - 1,
                                      replace=False).tolist())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    front = reference.FrontEnd(device)
    enroll_items: Dict[str, List[int]] = {}
    for speaker, item in traffic.enrollments(spec):
        enroll_items.setdefault(speaker, []).append(item)
    thr = spec["verify_threshold"]
    limit = cell.limits["score_gap"]
    precisions = {"ref": reference.PRECISIONS[conf["compute_dtype"]]}
    if args.control:
        low = reference.CONTROL_OF[conf["compute_dtype"]]
        precisions["control"] = reference.PRECISIONS[low]
        common.log(f"[verify] control ({low}) in the program's place: its answers are judged")
    cache: Dict = {}

    def emb(item, which):
        if (item, which) not in cache:
            pcm = torch.from_numpy(traffic.upload(args.seed, item, samples[item]).astype(np.int16))
            cache[(item, which)] = reference.embed_upload(p0, pcm.to(device), conf,
                                                          precisions[which], front)
        return cache[(item, which)]

    def score_of(item, speaker, which):
        return reference.verify_score(emb(item, which),
                                      [emb(j, which) for j in enroll_items[speaker]])

    t = time.perf_counter()
    gaps = []
    flips = 0
    for i in sorted(pick):
        _, _, _, _, score, decision, item, speaker = ok[i]
        if args.control:
            score = score_of(item, speaker, "control")
            decision = score >= thr
        ref_score = score_of(item, speaker, "ref")
        gaps.append(abs(score - ref_score))
        flips += (decision != (ref_score >= thr)) and abs(ref_score - thr) > limit
    common.log(f"[verify] reference over {len(pick)} answers in {time.perf_counter() - t:.2f} s; "
               f"scores seen {min(r[4] for r in ok):.6f}..{max(r[4] for r in ok):.6f}")
    checks["score_gap"] = (max(gaps), limit)
    checks["decision_flips"] = (float(flips), 0.0)
    return common.Outcome(attempted=len(recs), failed=len(recs) - len(ok), e2e=e2e, view=view,
                          checks=checks, memory_peak_bytes=peak)
