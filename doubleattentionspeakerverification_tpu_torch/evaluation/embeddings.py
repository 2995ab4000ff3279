"""Batched embedding extraction and trial scoring (JAX
``evaluation/embeddings.py``), for the trainer's validation and offline
extraction.

The reference's validation recomputes both utterances of every trial pair
with batch-of-1 forwards (``train.py:107-133``). Here unique utterances are
extracted once, in length-bucketed padded batches, cached, and trial
scoring is a vectorized cosine over cached embeddings. The length buckets
and the long-audio chunking are shared with the server (``serving.py``), so
served and offline embeddings follow one policy. The forwards are the
model's eval mode: kernel B1 pools on the card.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import normalize_np
from .eer import cosine_scores, eer_exact, eer_reference, min_dcf

DEFAULT_BUCKETS = (200, 350, 500, 750, 1000, 1500, 2000, 3000, 4000, 6000, 8000)


def pickle_feature_loader(data_dir: str, normalization: str = "cmn") -> Callable:
    """Loader for reference-format feature pickles: (80, T) raw -> (T, 80)
    normalized (``data.py:7-30``)."""

    def load(utt_id: str) -> np.ndarray:
        with open(f"{data_dir}/{utt_id}.pickle", "rb") as f:
            feats = pickle.load(f)
        return normalize_np(np.transpose(feats).astype(np.float32), normalization)

    return load


def wav_feature_loader(data_dir: str, feat_cfg=None, normalization: str = "cmn",
                       host_dsp: bool = False, device="cuda",
                       use_kernel: bool = True) -> Callable:
    """Loader for raw-wav validation sets: decode, log-mel, normalize (the
    ``getEmbeddingExample`` combination). The log-mel is kernel B2 on
    ``device`` (its plain version when ``device`` is the CPU or
    ``use_kernel`` is False, the kernel dispatcher's choice), or with
    ``host_dsp`` the native C++ kernel on the host (numpy without it), as
    training takes it when its features come from the host."""
    from ..config import FeatureConfig
    from ..data.wav import read_wav
    from ..dsp.features import make_device_logmel

    feat_cfg = feat_cfg or FeatureConfig()
    extractors = {}

    def get_extractor(cfg):
        if cfg not in extractors:
            if host_dsp:
                from ..utils.native import host_logmel_extractor

                extractors[cfg] = host_logmel_extractor(cfg, "none")
            else:
                extractors[cfg] = make_device_logmel(cfg, device, use_kernel)
        return extractors[cfg]

    def load(utt_id: str) -> np.ndarray:
        path = f"{data_dir}/{utt_id}"
        if not path.endswith(".wav"):
            path += ".wav"
        wave, sr = read_wav(path)
        cfg = feat_cfg if sr == feat_cfg.sample_rate else FeatureConfig(sample_rate=sr)
        feats = get_extractor(cfg)(wave.astype(np.float32))
        return normalize_np(feats, normalization)

    return load


class FeatureCache:
    """Byte-budgeted host cache around a feature loader: the features of a
    validation set do not change between rounds, the embeddings do.
    Insertion stops at the budget (no eviction)."""

    def __init__(self, loader: Callable[[str], np.ndarray], budget_mb: float = 512.0):
        self._loader = loader
        self._cache: Dict[str, np.ndarray] = {}
        self._budget = int(budget_mb * 1e6)

    def __call__(self, utt_id: str) -> np.ndarray:
        feats = self._cache.get(utt_id)
        if feats is None:
            feats = self._loader(utt_id)
            if self._budget >= feats.nbytes:
                self._budget -= feats.nbytes
                self._cache[utt_id] = feats
        return feats


def split_long_audio(feats, chunk: int, min_tail: int = 50) -> List:
    """Non-overlapping ``chunk``-frame pieces along axis 0; a final piece
    under ``min_tail`` frames (half a second at 100 fps) is dropped."""
    segs = [feats[i : i + chunk] for i in range(0, feats.shape[0], chunk)]
    if len(segs) > 1 and segs[-1].shape[0] < min_tail:
        segs.pop()
    return segs


def weighted_unit_centroid(embs, weights) -> np.ndarray:
    """Duration-weighted mean of L2-normalized embeddings."""
    acc, wsum = None, 0.0
    for e, w in zip(embs, weights):
        e = np.asarray(e, np.float64)
        e = e / max(1e-12, float(np.linalg.norm(e)))
        acc = float(w) * e if acc is None else acc + float(w) * e
        wsum += float(w)
    return (acc / wsum).astype(np.float32)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that holds ``length``; beyond the grid, a multiple of
    the largest bucket."""
    for b in buckets:
        if length <= b:
            return b
    big = buckets[-1]
    return -(-length // big) * big


class EmbeddingExtractor:
    """Extract-once cache of scoring embeddings from ``model`` (a
    ``SpeakerClassifier``; its eval-mode forward, the model's mode restored
    after), or from ``embed_fn(x, lengths) -> (B, emb)`` where one is given
    (the int8 encoder, ``models/quantized.py:make_int8_embed_fn``), run with
    ``model`` in eval mode and on its device. The model's pooling takes the
    kernel dispatcher's choice for its device (``utils/kernel_auto.py``).

    Features load on a host thread pool; every bucketed batch of
    ``batch_size`` rows is launched before any result is read back (CUDA
    launches are asynchronous), and the results are read once at the end.
    Utterances up to ``max_frames`` (default 2x the largest bucket) embed at
    full length; beyond it ``long_audio='chunk'`` embeds largest-bucket
    chunks and keeps their duration-weighted unit centroid, and
    ``long_audio='pad'`` embeds the whole utterance in one padded row.
    """

    def __init__(self, model: torch.nn.Module, feature_loader: Callable[[str], np.ndarray],
                 batch_size: int = 8, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 num_workers: int = 4, long_audio: str = "chunk",
                 max_frames: Optional[int] = None,
                 stream: Optional["torch.cuda.Stream"] = None,
                 embed_fn: Optional[Callable] = None):
        from ..utils.kernel_auto import resolve_model_kernels, route_model

        self.device = next(model.parameters()).device
        # embeds from features: the log-mel is never run here
        self.model = route_model(model, resolve_model_kernels(model.cfg, need_dsp=False,
                                                              device=self.device))
        self._embed = model if embed_fn is None else embed_fn
        self.load = feature_loader
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        if long_audio not in ("chunk", "pad"):
            raise ValueError(f"unknown long_audio policy {long_audio!r}")
        self.long_audio = long_audio
        self.max_frames = 2 * self.buckets[-1] if max_frames is None else int(max_frames)
        self.cache: Dict[str, np.ndarray] = {}
        self.n_embedded = 0  # utterances run through the model (not cache hits)
        self.num_workers = max(1, num_workers)
        self.stream = stream

    def _load_all(self, todo: List[str]) -> Dict[str, np.ndarray]:
        if len(todo) <= 1 or self.num_workers == 1:
            return {u: self.load(u) for u in todo}
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            return dict(zip(todo, ex.map(self.load, todo)))

    def _pieces(self, f: np.ndarray) -> List[np.ndarray]:
        if self.long_audio != "chunk" or f.shape[0] <= self.max_frames:
            return [f]
        return split_long_audio(f, self.buckets[-1])

    @torch.no_grad()
    def _forward(self, batches) -> List[Tuple[List[Tuple[str, int]], np.ndarray]]:
        pending = []
        was_training = self.model.training
        self.model.eval()
        try:
            for keys, x, lengths in batches:
                xt = torch.from_numpy(x).to(self.device, non_blocking=True)
                lt = torch.from_numpy(lengths.astype(np.int64)).to(self.device, non_blocking=True)
                pending.append((keys, self._embed(xt, lt)))
        finally:
            self.model.train(was_training)
        return [(keys, emb.cpu().numpy()) for keys, emb in pending]

    def extract(self, utt_ids: Sequence[str]) -> Dict[str, np.ndarray]:
        todo = sorted(set(u for u in utt_ids if u not in self.cache))
        if not todo:
            return self.cache
        feats = self._load_all(todo)
        pieces: Dict[Tuple[str, int], np.ndarray] = {}
        n_pieces: Dict[str, int] = {}
        for u in todo:
            segs = self._pieces(feats[u])
            n_pieces[u] = len(segs)
            for k, seg in enumerate(segs):
                pieces[(u, k)] = seg
        by_bucket: Dict[int, List[Tuple[str, int]]] = {}
        for key, seg in pieces.items():
            by_bucket.setdefault(bucket_for(seg.shape[0], self.buckets), []).append(key)

        batches = []
        for bucket, keys in sorted(by_bucket.items()):
            keys.sort()
            for i in range(0, len(keys), self.batch_size):
                chunk = keys[i : i + self.batch_size]
                x = np.zeros((self.batch_size, bucket, pieces[chunk[0]].shape[1]), np.float32)
                lengths = np.zeros((self.batch_size,), np.int32)
                for j, key in enumerate(chunk):
                    f = pieces[key]
                    x[j, : f.shape[0]] = f
                    lengths[j] = f.shape[0]
                batches.append((chunk, x, lengths))
                self.n_embedded += len(chunk)
        if self.stream is not None:
            with torch.cuda.stream(self.stream):
                results = self._forward(batches)
        else:
            results = self._forward(batches)
        piece_emb: Dict[Tuple[str, int], np.ndarray] = {}
        for chunk, emb in results:
            for j, key in enumerate(chunk):
                piece_emb[key] = emb[j]
        for u in todo:
            if n_pieces[u] == 1:
                self.cache[u] = piece_emb[(u, 0)]
            else:
                self.cache[u] = weighted_unit_centroid(
                    [piece_emb[(u, k)] for k in range(n_pieces[u])],
                    [pieces[(u, k)].shape[0] for k in range(n_pieces[u])],
                )
        return self.cache


def save_embeddings(path: str, embeddings: Dict[str, np.ndarray], quantize: str = "none") -> None:
    """An utterance -> embedding map as ``.npz`` (the JAX package's format:
    an id array, the row matrix, and the ``quantize`` tag of the model path
    that made the rows)."""
    ids = sorted(embeddings)
    np.savez_compressed(
        path,
        ids=np.asarray(ids, dtype=np.str_),
        embeddings=np.stack([embeddings[u] for u in ids]).astype(np.float32),
        quantize=np.asarray(quantize),
    )


def load_embeddings(path: str, expect_quantize: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Load a :func:`save_embeddings` store (either package's); warns when
    ``expect_quantize`` disagrees with the store's tag (a store without the
    tag reads as 'none')."""
    with np.load(path, allow_pickle=False) as z:
        ids, embs = z["ids"], z["embeddings"]
        stored = str(z["quantize"]) if "quantize" in z.files else "none"
    if expect_quantize is not None and stored != expect_quantize:
        import warnings

        warnings.warn(
            f"embedding store {path!r} was written by a quantize={stored!r} "
            f"run but is being consumed by a quantize={expect_quantize!r} "
            "run; int8 and fp embeddings cosine-drift ~1e-3 — do not mix "
            "them in parity EERs",
            stacklevel=2,
        )
    return {str(u): embs[i] for i, u in enumerate(ids)}


def score_trials(extractor: EmbeddingExtractor, trials: Sequence[Tuple[str, str]]) -> np.ndarray:
    ids = [u for pair in trials for u in pair]
    cache = extractor.extract(ids)
    e1 = np.stack([cache[a] for a, _ in trials])
    e2 = np.stack([cache[b] for _, b in trials])
    return cosine_scores(e1, e2)


def validate_eer(extractor: EmbeddingExtractor, client_trials: Sequence[Tuple[str, str]],
                 impostor_trials: Sequence[Tuple[str, str]]) -> Dict[str, float]:
    cl = score_trials(extractor, client_trials)
    im = score_trials(extractor, impostor_trials)
    return {
        "eer": eer_reference(cl, im),
        "eer_exact": eer_exact(cl, im),
        "min_dcf": min_dcf(cl, im),
        "mean_client": float(np.mean(cl)),
        "mean_impostor": float(np.mean(im)),
    }


def sharded_extract(extractor: EmbeddingExtractor, utt_ids: Sequence[str], host_id: int,
                    num_hosts: int) -> int:
    """Multi-process extraction (JAX ``sharded_extract``): each process
    embeds only its shard of the sorted unique utterances (process h takes
    ``utts[h::n]``, at most ceil(n / processes) of them), then the
    embeddings are gathered so every process holds the whole cache and
    computes the same EER. A row's embedding does not depend on the others
    in its padded batch, so the gathered cache is what one process would
    have extracted. A collective: every process calls it at the same point
    with the same ``utt_ids``. Returns this process's shard size."""
    from ..parallel.distributed import all_gather_np

    utts = sorted(set(utt_ids))
    todo = [u for u in utts if u not in extractor.cache]
    if not todo:  # the caches are gathered alike, so every process agrees
        return 0
    shards = [todo[h::num_hosts] for h in range(num_hosts)]
    local = shards[host_id]
    extractor.extract(local)
    buf = np.zeros((max(len(s) for s in shards), extractor.model.cfg.embedding_size), np.float32)
    for i, u in enumerate(local):
        buf[i] = extractor.cache[u]
    gathered = all_gather_np(buf)
    for h, shard in enumerate(shards):
        for i, u in enumerate(shard):
            extractor.cache[u] = gathered[h, i]
    return len(local)
