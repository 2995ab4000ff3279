"""Embedding serving: micro-batched inference + a dependency-free HTTP server.

The port of the JAX package's ``serving.py`` to PyTorch on one GPU. On the
card a forward of 8 utterances costs little more than one, so concurrent
requests share padded batches. This module provides

- :class:`MicroBatcher` — collects concurrent embed requests for up to
  ``max_wait_ms``, pads them into length-bucketed batches, runs ONE forward
  per bucket and fans results back out;
- :func:`make_server` / :func:`serve_forever` — a stdlib-only
  ``ThreadingHTTPServer``:

    GET  /health            -> {"status": "ok", ...counters}
    POST /embed             -> body: RIFF/WAVE bytes; {"embedding": [...]}
    POST /score             -> {"a": [emb], "b": [emb]} -> {"score": cos}

plus speaker enrollment (:class:`EnrollmentDB` — the verification workflow
the reference leaves to the user: enroll N utterances per speaker, verify
against the speaker's centroid, identify against all enrolled speakers):

    POST /enroll?speaker=s  -> body: WAV; {"speaker": s, "enrollments": n}
    POST /verify?speaker=s  -> body: WAV; {"score": cos, "decision": bool}
    POST /identify?top_k=3  -> body: WAV; {"speakers": [{speaker, score}]}
    GET  /speakers          -> {"speakers": {s: n_enrollments}}
    POST /unenroll?speaker=s-> {"removed": n}

Uploads are decoded on the host and turned into features on the model's
device (kernel B2 on the card); the features stay there until the forward.

CLI: ``python -m doubleattentionspeakerverification_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .api import SpeakerEmbeddingModel
from .data.wav import decode_wav_bytes
from .evaluation.eer import cosine_scores
from .evaluation.embeddings import bucket_for, split_long_audio, weighted_unit_centroid

SERVE_BUCKETS = (100, 200, 350, 500, 750, 1000, 1500, 2000, 3000, 4000, 6000, 8000)


class AudioTooLong(ValueError):
    """Upload longer than the largest serving length bucket (HTTP 413)."""


class ServerOverloaded(RuntimeError):
    """Load shed: the batcher's pending-request bound is full (HTTP 503 +
    Retry-After). Shedding at admission keeps memory and tail latency
    bounded under a client flood: queueing unboundedly ahead of the card
    would grow memory and p99 without limit while every queued client
    eventually times out anyway."""


class _Pending:
    __slots__ = ("feats", "event", "result", "error", "created")

    def __init__(self, feats: torch.Tensor):
        self.feats = feats
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.created = time.monotonic()


class MicroBatcher:
    """Batch concurrent embedding requests into length-bucketed forwards.

    Requests that arrive within ``max_wait_ms`` of each other share one
    forward of up to ``max_batch`` rows, padded in time to their bucket. The
    time grid keeps the set of convolution shapes small; rows are not padded
    to ``max_batch``, since an eager forward compiles nothing per shape and
    padding rows would cost the card a full utterance each.
    """

    def __init__(
        self,
        model: SpeakerEmbeddingModel,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        buckets: Sequence[int] = SERVE_BUCKETS,
        embed_timeout_s: float = 600.0,
        pipeline: int = 2,
        max_pending: int = 512,
        long_audio: str = "reject",
    ):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.buckets = tuple(buckets)
        # uploads beyond the largest bucket: 'reject' (default, HTTP 413 —
        # the client is told to split) or 'chunk' — largest-bucket chunks
        # batched like ordinary requests (each chunk paying admission
        # control) and combined as the duration-weighted centroid of unit
        # chunk embeddings, the same policy as the offline extractor
        # (evaluation/embeddings.py)
        if long_audio not in ("reject", "chunk"):
            raise ValueError(f"unknown long_audio policy {long_audio!r}")
        self.long_audio = long_audio
        self.embed_timeout_s = embed_timeout_s
        # admission bound: embed() raises ServerOverloaded once this many
        # clients are already waiting (0 = unbounded). 512 ~= 32 full
        # forwards of backlog at the default max_batch — deep enough to
        # ride bursts, shallow enough that shed clients get their 503 in
        # microseconds instead of a timeout minutes later.
        self.max_pending = max_pending
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        # `pending` is a live gauge of CLIENTS CURRENTLY WAITING in embed():
        # /health exposing it lets ops — and the robustness tests — assert
        # the batcher leaks nothing after error storms. A timed-out client
        # decrements it while its abandoned work may still be in flight in
        # the worker. `errors` counts requests that ended with an exception
        # delivered to the client, timeouts included.
        self._stats = {"requests": 0, "forwards": 0, "batched": 0,
                       "pending": 0, "errors": 0, "shed": 0}
        self._stats_lock = threading.Lock()
        # `pipeline` forwards may be in flight at once: the collector keeps
        # assembling the next batch while earlier forwards run and wait out
        # their device-to-host copy. pipeline=1 restores the fully serial
        # worker.
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, pipeline), thread_name_prefix="mb-flush"
        )
        # one permit per in-flight forward: the collector keeps ACCUMULATING
        # requests while no slot is free (that backpressure is what grows
        # batches — submitting unconditionally would drain the queue into
        # singleton forwards and destroy the batching ratio)
        self._sem = threading.Semaphore(max(1, pipeline))
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client
    def embed(self, feats, timeout: Optional[float] = None) -> np.ndarray:
        """(T, F) normalized features (array or tensor, on any device) ->
        (emb,). Thread-safe, blocking.

        Inputs beyond the largest length bucket either raise
        :class:`AudioTooLong` (``long_audio='reject'``, the default — an
        unbounded utterance would hold the card and its memory for as long
        as the client likes) or, with ``long_audio='chunk'``, are embedded as
        largest-bucket chunks combined into the duration-weighted centroid
        of unit chunk embeddings (the offline extractor's policy)."""
        feats = torch.as_tensor(feats, dtype=torch.float32)
        if feats.shape[0] <= self.buckets[-1]:
            return self._wait_result(self._submit(feats), timeout)
        if self.long_audio != "chunk":
            raise AudioTooLong(
                f"{feats.shape[0]} frames exceeds the largest serving "
                f"bucket ({self.buckets[-1]}); split the audio, raise "
                "--buckets, or serve with --long_audio chunk"
            )
        return self._embed_chunked(feats, timeout)

    def _admit_many(self, n: int) -> None:
        """All-or-nothing admission of ``n`` work items (a multi-chunk
        request must not hold slots while its remaining chunks shed)."""
        with self._stats_lock:
            if self.max_pending and self._stats["pending"] + n > self.max_pending:
                # shed at admission: nothing is queued, nothing leaks
                self._stats["shed"] += 1
                raise ServerOverloaded(
                    f"{self._stats['pending']} requests already pending "
                    f"(bound {self.max_pending}); retry shortly"
                )
            self._stats["pending"] += n

    def _submit(self, feats: torch.Tensor) -> _Pending:
        self._admit_many(1)
        p = _Pending(feats)
        self._q.put(p)
        return p

    def _wait_result(self, p: _Pending, timeout: Optional[float]) -> np.ndarray:
        try:
            if not p.event.wait(self.embed_timeout_s if timeout is None else timeout):
                with self._stats_lock:
                    self._stats["errors"] += 1
                raise TimeoutError("embedding request timed out")
            if p.error is not None:
                with self._stats_lock:
                    self._stats["errors"] += 1
                raise p.error
            return p.result
        finally:
            with self._stats_lock:
                self._stats["pending"] -= 1

    def _embed_chunked(self, feats: torch.Tensor, timeout: Optional[float]) -> np.ndarray:
        segs = split_long_audio(feats, self.buckets[-1])
        if self.max_pending and len(segs) > self.max_pending:
            # NON-retryable (413, not 503): this request can never fit the
            # admission bound, so 'retry shortly' would loop forever
            raise AudioTooLong(
                f"{feats.shape[0]} frames needs {len(segs)} chunks, beyond "
                f"the --max_pending bound ({self.max_pending}); split the "
                "audio or raise the bound"
            )
        self._admit_many(len(segs))
        pendings = [_Pending(s) for s in segs]
        for p in pendings:
            self._q.put(p)
        # one overall deadline across the chunks (they batch/pipeline
        # concurrently, so the wall-clock is ~one chunk's latency)
        deadline = time.monotonic() + (
            self.embed_timeout_s if timeout is None else timeout
        )
        embs, released = [], set()

        def wait_one(p):
            try:
                return self._wait_result(p, max(0.0, deadline - time.monotonic()))
            finally:
                # _wait_result releases p's slot on every path; record it so
                # the outer finally can release exactly the never-waited rest
                # (an exception may also come from OUTSIDE _wait_result, e.g.
                # KeyboardInterrupt between chunks — no slot may leak)
                released.add(id(p))

        try:
            for p in pendings:
                embs.append(wait_one(p))
        finally:
            leftover = [p for p in pendings if id(p) not in released]
            if leftover:
                with self._stats_lock:
                    self._stats["pending"] -= len(leftover)
        return weighted_unit_centroid(embs, [s.shape[0] for s in segs])

    def close(self) -> None:
        self._q.put(None)
        self._worker.join(timeout=5)
        self._pool.shutdown(wait=True)  # drain in-flight forwards

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def warmup(self, frame_lengths: Sequence[int]) -> None:
        """Run one forward for each bucket covering these lengths, so the
        first real request does not pay cuDNN's first-call set-up."""
        for t in sorted({bucket_for(t, self.buckets) for t in frame_lengths}):
            feat_dim = self.model.cfg.model.feature_size
            self.embed(torch.zeros((t, feat_dim)))
        # warmup traffic shouldn't pollute the /health counters
        with self._stats_lock:
            self._stats.update(requests=0, forwards=0, batched=0)

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        # Requests accumulate PER BUCKET: mixed-length traffic splits across
        # length buckets, and a total-size cap would hand every forward only
        # max_batch/n_active_buckets rows (measured: avg batch stuck at ~4/16
        # under 64-client saturation with 4 live buckets). The window closes
        # when some single bucket can fill a forward, and each bucket chunk
        # is submitted as its own pipelined forward, fullest first.
        shutdown = False
        while not shutdown:
            first = self._q.get()
            if first is None:
                return
            pending: dict = {}

            def add(p):
                pending.setdefault(
                    bucket_for(p.feats.shape[0], self.buckets), []
                ).append(p)

            add(first)
            # phase 1: the batching window (max_wait_ms)
            deadline = time.monotonic() + self.max_wait_s
            while max(len(v) for v in pending.values()) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    shutdown = True
                    break
                add(nxt)
            # phase 2: submit bucket chunks; while waiting for a pipeline
            # slot keep draining the queue — under load this extends the
            # batching window to exactly the in-flight forwards' duration
            # instead of queueing singleton forwards
            while pending:
                while not self._sem.acquire(timeout=0.002):
                    while not shutdown:
                        try:
                            nxt = self._q.get_nowait()
                        except queue.Empty:
                            break
                        if nxt is None:
                            shutdown = True
                        else:
                            add(nxt)
                # OLDEST-waiting bucket first, not fullest: under sustained
                # load the slot-wait drain keeps refilling hot buckets, and
                # fullest-first would starve a sparse bucket's lone request
                # until embed_timeout. Oldest-first is starvation-free and
                # batches just as well (the oldest bucket has been
                # accumulating co-riders the longest).
                bucket = min(pending, key=lambda b: pending[b][0].created)
                items = pending.pop(bucket)
                chunk, rest = items[: self.max_batch], items[self.max_batch :]
                if rest:
                    pending[bucket] = rest
                try:
                    self._pool.submit(self._flush_release, chunk)
                except RuntimeError:
                    # close() may shut the pool down while we were topping up
                    # the final batch (the 5 s worker join can expire
                    # mid-forward); flush inline so no client blocks until
                    # embed_timeout_s
                    self._flush_release(chunk)

    def _flush_release(self, chunk) -> None:
        try:
            self._flush(chunk)
        finally:
            self._sem.release()

    def _flush(self, chunk) -> None:
        """One forward for one bucket's chunk of at most ``max_batch``
        requests (``_run`` hands over nothing else)."""
        with self._stats_lock:
            self._stats["requests"] += len(chunk)
            self._stats["batched"] += len(chunk) > 1
        try:
            bucket = bucket_for(max(p.feats.shape[0] for p in chunk), self.buckets)
            feat_dim = chunk[0].feats.shape[1]
            x = torch.zeros((len(chunk), bucket, feat_dim), device=self.model.device)
            for j, p in enumerate(chunk):
                x[j, : p.feats.shape[0]] = p.feats
            emb = self.model.embed_features(x, [p.feats.shape[0] for p in chunk])
            with self._stats_lock:
                self._stats["forwards"] += 1
            for j, p in enumerate(chunk):
                p.result = emb[j]
        except BaseException as e:  # deliver to every waiting client
            for p in chunk:
                p.error = e
            if not isinstance(e, Exception):
                raise
        finally:
            for p in chunk:
                p.event.set()


class EnrollmentDB:
    """Thread-safe speaker-enrollment store.

    Each speaker keeps every enrollment embedding; the speaker model is the
    renormalized mean of the L2-normalized enrollments (the standard
    multi-enrollment centroid — robust to per-utterance norm differences,
    and cosine against it equals the mean pairwise cosine up to the
    renormalization). Optional persistence to one .npz (ids = "speaker"
    per row, aligned with the embedding matrix), written atomically on
    every mutation when ``path`` is given — durability-first: each
    enroll/unenroll rewrites the whole store (~16 MB at 10k x 400), the
    right trade for the enroll-rarely/identify-often workload this serves;
    a write-heavy enrollment pipeline should batch through one process and
    expect O(store) disk per mutation.
    """

    def __init__(self, path: Optional[str] = None):
        self._by_speaker: Dict[str, List[np.ndarray]] = {}
        self._lock = threading.Lock()
        self._path = path
        # identify() cache: (names list, stacked unit-centroid matrix),
        # rebuilt lazily after any mutation — a 10k-speaker identify is one
        # matvec instead of 10k per-speaker lock/renormalize round trips
        self._centroid_cache: Optional[tuple] = None
        if path and os.path.exists(path):
            with np.load(path, allow_pickle=False) as z:
                for spk, emb in zip(z["ids"], z["embeddings"]):
                    self._by_speaker.setdefault(str(spk), []).append(
                        np.asarray(emb, np.float32)
                    )

    def _save_locked(self) -> None:
        if not self._path:
            return
        ids, rows = [], []
        for spk in sorted(self._by_speaker):
            for e in self._by_speaker[spk]:
                ids.append(spk)
                rows.append(e)
        tmp = self._path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            ids=np.asarray(ids, dtype=np.str_),
            embeddings=(
                np.stack(rows).astype(np.float32) if rows else np.zeros((0, 1), np.float32)
            ),
        )
        os.replace(tmp, self._path)

    def enroll(self, speaker: str, embedding: np.ndarray) -> int:
        with self._lock:
            self._by_speaker.setdefault(speaker, []).append(
                np.asarray(embedding, np.float32)
            )
            self._centroid_cache = None
            self._save_locked()
            return len(self._by_speaker[speaker])

    def unenroll(self, speaker: str) -> int:
        with self._lock:
            removed = len(self._by_speaker.pop(speaker, []))
            if removed:
                self._centroid_cache = None
                self._save_locked()
            return removed

    def speakers(self) -> Dict[str, int]:
        with self._lock:
            return {s: len(v) for s, v in self._by_speaker.items()}

    @staticmethod
    def _unit_centroid(embs: List[np.ndarray]) -> np.ndarray:
        unit = np.stack(
            [e / max(1e-12, float(np.linalg.norm(e))) for e in embs]
        )
        c = unit.mean(axis=0)
        return c / max(1e-12, float(np.linalg.norm(c)))

    def centroid(self, speaker: str) -> Optional[np.ndarray]:
        with self._lock:
            embs = self._by_speaker.get(speaker)
            if not embs:
                return None
            return self._unit_centroid(embs)

    def score(self, embedding: np.ndarray, speaker: str) -> Optional[float]:
        c = self.centroid(speaker)
        if c is None:
            return None
        return float(cosine_scores(np.asarray(embedding, np.float32)[None], c[None])[0])

    def _centroid_matrix(self) -> tuple:
        """(names, (N, emb) unit-centroid matrix), cached until a mutation."""
        with self._lock:
            if self._centroid_cache is None:
                names = sorted(self._by_speaker)
                mat = (
                    np.stack([self._unit_centroid(self._by_speaker[s])
                              for s in names])
                    if names else np.zeros((0, 1), np.float32)
                )
                self._centroid_cache = (names, mat)
            return self._centroid_cache

    def identify(self, embedding: np.ndarray, top_k: int = 3) -> List[Dict]:
        names, mat = self._centroid_matrix()
        if not names:
            return []
        q = np.asarray(embedding, np.float32)
        q = q / max(1e-12, float(np.linalg.norm(q)))
        # centroids are unit rows, so cosine == one matvec
        scores = mat @ q
        k = min(max(1, top_k), len(names))
        top = np.argsort(-scores)[:k]
        return [{"speaker": names[i], "score": float(scores[i])} for i in top]


def make_server(
    model: SpeakerEmbeddingModel,
    host: str = "127.0.0.1",
    port: int = 0,
    max_batch: int = 8,
    max_wait_ms: float = 5.0,
    embed_timeout_s: float = 600.0,
    enrollment_db: Optional[str] = None,
    verify_threshold: float = 0.5,
    pipeline: int = 2,
    max_body_mb: float = 64.0,
    max_pending: int = 512,
    long_audio: str = "reject",
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; ``.server_address`` has the port."""
    batcher = MicroBatcher(model, max_batch=max_batch, max_wait_ms=max_wait_ms,
                           embed_timeout_s=embed_timeout_s, pipeline=pipeline,
                           max_pending=max_pending, long_audio=long_audio)
    db = EnrollmentDB(enrollment_db)
    t0 = time.time()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; metrics live in /health
            pass

        def _json(self, code: int, obj, headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _embed_body(self, body: bytes) -> np.ndarray:
            wave, sr = decode_wav_bytes(body)
            # rate-adjusted front-end; the log-mel is kernel B2 on the card
            feats = model.features_of_wave(wave, sr)
            if feats.shape[0] == 0:
                raise ValueError("audio shorter than one analysis frame")
            self._frames = int(feats.shape[0])
            return batcher.embed(feats)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/health":
                self._json(200, {
                    "status": "ok",
                    "model": model.cfg.describe(),
                    "device": str(model.device),
                    "uptime_s": round(time.time() - t0, 1),
                    **batcher.stats(),
                })
            elif path == "/speakers":
                self._json(200, {"speakers": db.speakers()})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    return self._json(400, {"error": "invalid Content-Length"})
                if n < 0:
                    return self._json(400, {"error": "invalid Content-Length"})
                if n > max_body_mb * 1e6:
                    # refuse WITHOUT buffering: discard (bounded) the body
                    # the client is still uploading so the 413 response
                    # reaches it before the close — closing with unread
                    # in-flight data can RST the connection and the client
                    # would see ECONNRESET instead of the 413. The drain is
                    # bounded in BYTES (cap) and TIME (socket timeout) so a
                    # hostile oversized/slow-loris stream cannot pin the
                    # handler thread; past either bound the connection
                    # closes anyway.
                    drain_cap = int(4 * max_body_mb * 1e6)
                    remaining = min(n, drain_cap)
                    try:
                        self.connection.settimeout(10.0)
                        while remaining > 0:
                            chunk = self.rfile.read(min(65536, remaining))
                            if not chunk:
                                break
                            remaining -= len(chunk)
                    except OSError:
                        pass  # slow/stalled client: respond with what we have
                    self._json(413, {
                        "error": f"body {n} bytes exceeds the "
                                 f"{max_body_mb:.0f} MB limit"
                    })
                    self.close_connection = True
                    return
                body = self.rfile.read(n)
                parsed = urllib.parse.urlparse(self.path)
                query = dict(urllib.parse.parse_qsl(parsed.query))
                path = parsed.path
                if path == "/embed":
                    emb = self._embed_body(body)
                    self._json(200, {
                        "embedding": [float(v) for v in emb],
                        "frames": self._frames,
                    })
                elif path == "/enroll":
                    speaker = query.get("speaker")
                    if not speaker:
                        return self._json(400, {"error": "missing ?speaker="})
                    count = db.enroll(speaker, self._embed_body(body))
                    self._json(200, {"speaker": speaker, "enrollments": count})
                elif path == "/verify":
                    speaker = query.get("speaker")
                    if not speaker:
                        return self._json(400, {"error": "missing ?speaker="})
                    score = db.score(self._embed_body(body), speaker)
                    if score is None:
                        return self._json(404, {"error": f"speaker {speaker!r} not enrolled"})
                    thr = float(query.get("threshold", verify_threshold))
                    self._json(200, {
                        "speaker": speaker,
                        "score": score,
                        "threshold": thr,
                        "decision": bool(score >= thr),
                    })
                elif path == "/identify":
                    if not db.speakers():
                        return self._json(404, {"error": "no speakers enrolled"})
                    top_k = int(query.get("top_k", 3))
                    self._json(200, {"speakers": db.identify(self._embed_body(body), top_k)})
                elif path == "/unenroll":
                    speaker = query.get("speaker")
                    if not speaker:
                        return self._json(400, {"error": "missing ?speaker="})
                    self._json(200, {"speaker": speaker, "removed": db.unenroll(speaker)})
                elif path == "/score":
                    req = json.loads(body)
                    a = np.asarray(req["a"], np.float32)
                    b = np.asarray(req["b"], np.float32)
                    self._json(200, {"score": float(cosine_scores(a[None], b[None])[0])})
                else:
                    self._json(404, {"error": f"unknown path {path}"})
            except AudioTooLong as e:
                self._json(413, {"error": f"{type(e).__name__}: {e}"})
            except ServerOverloaded as e:
                # load shed at admission: tell the client when to retry
                # (one batching window + one forward's worth of backoff)
                self._json(503, {"error": f"{type(e).__name__}: {e}"},
                           headers=(("Retry-After", "1"),))
            except TimeoutError as e:
                # server-side saturation, not a client mistake
                self._json(503, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher  # for tests / clean shutdown
    server.enrollments = db
    return server


def serve_forever(server: ThreadingHTTPServer, install_sigterm: bool = True,
                  drain_timeout_s: float = 120.0) -> None:
    """Run until shutdown. With ``install_sigterm`` (the CLI default),
    SIGTERM triggers a graceful drain: the listener stops accepting, handler
    threads finish their in-flight requests, the batcher flushes, and the
    process exits 0 — mirroring the trainer's preemption semantics.

    The drain genuinely WAITS: ThreadingHTTPServer's handler threads are
    daemons, so returning immediately after ``shutdown()`` would let the
    interpreter kill them mid-request. After the accept loop stops
    we poll the batcher's pending gauge to zero (bounded by
    ``drain_timeout_s``) plus a short grace for response writes."""
    if install_sigterm:
        def _on_sigterm(signum, frame):
            # shutdown() blocks until serve_forever returns — must not be
            # called from the signal handler's (main) thread while that
            # same thread sits in serve_forever
            threading.Thread(target=server.shutdown, daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            pass  # non-main thread / restricted environment
    try:
        server.serve_forever()
    finally:
        deadline = time.monotonic() + drain_timeout_s
        while (server.batcher.stats()["pending"] > 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(0.2)  # grace: handlers write responses after embed returns
        server.batcher.close()
