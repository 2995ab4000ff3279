"""Embedding-serving CLI.

Starts the micro-batched HTTP embedding server (``serving.py``) on a JAX
package ``.npz`` checkpoint, on the GPU unless ``--device cpu``:

  python -m doubleattentionspeakerverification_tpu_torch.cli.serve \\
      --modelCheckpoint models/run1/..._best_1234.npz --port 8390

  curl -s -X POST --data-binary @spk.wav localhost:8390/embed
  curl -s localhost:8390/health

``--quantize int8_static --calibration_wav cal.wav --int8_scales s.npz``
serves the int8 encoder (kernel B3 on the card) with scales calibrated
before serving and kept for restarts.
"""

from __future__ import annotations

import argparse

from ..api import QUANTIZE_MODES, SpeakerEmbeddingModel
from ..serving import make_server, serve_forever


def build_server(argv=None):
    parser = argparse.ArgumentParser(description="Serve speaker embeddings over HTTP.")
    parser.add_argument("--modelCheckpoint", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8390)
    parser.add_argument("--normalization", type=str, default="cmn", choices=["cmn", "cmvn"])
    parser.add_argument("--max_batch", type=int, default=8,
                        help="requests per fused forward")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="how long the batcher waits for co-riders")
    parser.add_argument("--pipeline", type=int, default=2,
                        help="embedding forwards allowed in flight at once "
                             "(1 = serial)")
    parser.add_argument("--embed_timeout_s", type=float, default=600.0,
                        help="per-request wait bound")
    parser.add_argument("--quantize", type=str, default="none",
                        choices=list(QUANTIZE_MODES),
                        help="'int8': int8 conv encoder with dynamic activation "
                             "scales; 'int8_static': scales calibrated on the first "
                             "real batch (degenerate warmup/silence batches are "
                             "refused) and folded into every conv's epilogue, under "
                             "a one-shot cosine guard against the fp model that "
                             "falls back to the dynamic path on failure")
    parser.add_argument("--calibration_wav", type=str, default=None,
                        help="int8_static only: calibrate the scales on this wav "
                             "BEFORE serving (otherwise the first real request "
                             "calibrates)")
    parser.add_argument("--int8_scales", type=str, default=None,
                        help="int8_static only: load the scales from this .npz if "
                             "it exists, else write them there after the first "
                             "successful calibration (deterministic restarts)")
    parser.add_argument("--max_body_mb", type=float, default=64.0,
                        help="reject POST bodies larger than this (HTTP 413) "
                             "before buffering them")
    parser.add_argument("--max_pending", type=int, default=512,
                        help="load-shed bound: once this many requests are "
                             "waiting, new ones get HTTP 503 + Retry-After "
                             "immediately (0 = unbounded)")
    parser.add_argument("--long_audio", type=str, default="reject",
                        choices=["reject", "chunk"],
                        help="uploads beyond the largest length bucket: "
                             "'reject' = HTTP 413; 'chunk' = embed "
                             "largest-bucket chunks and return their "
                             "duration-weighted unit-embedding centroid")
    parser.add_argument("--enrollment_db", type=str, default=None,
                        help="persist speaker enrollments to this .npz "
                             "(loaded at startup, written on every change)")
    parser.add_argument("--verify_threshold", type=float, default=0.5,
                        help="default cosine threshold for /verify decisions "
                             "(override per request with ?threshold=)")
    parser.add_argument("--warmup", type=str, default="",
                        help="comma-separated frame lengths (100 frames = 1 s) "
                             "whose buckets run one forward before serving, "
                             "e.g. --warmup 350,1000")
    params = parser.parse_args(argv)

    if params.quantize != "int8_static" and (params.calibration_wav or params.int8_scales):
        parser.error("--calibration_wav/--int8_scales require --quantize int8_static")
    model = SpeakerEmbeddingModel.from_checkpoint(
        params.modelCheckpoint, params.normalization, device=params.device,
        quantize=params.quantize, quantize_scales_path=params.int8_scales)
    if params.calibration_wav and model.quantize_calibration_state() != "static":
        state = model.calibrate_quantization_wav(params.calibration_wav)
        print(f"int8_static calibration on {params.calibration_wav}: {state}")
    server = make_server(model, params.host, params.port,
                         params.max_batch, params.max_wait_ms,
                         embed_timeout_s=params.embed_timeout_s,
                         enrollment_db=params.enrollment_db,
                         verify_threshold=params.verify_threshold,
                         pipeline=params.pipeline,
                         max_body_mb=params.max_body_mb,
                         max_pending=params.max_pending,
                         long_audio=params.long_audio)
    if params.warmup:
        lengths = [int(t) for t in params.warmup.split(",") if t.strip()]
        print(f"warming up buckets for frame lengths {lengths} ...")
        server.batcher.warmup(lengths)
    print(f"serving {params.modelCheckpoint} on {model.device} at "
          f"http://{server.server_address[0]}:{server.server_address[1]}")
    return server


def main(argv=None) -> int:
    serve_forever(build_server(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
