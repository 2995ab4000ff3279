"""The plain reference of what the benchmark's cells run: the paper's model
(arXiv:2007.13199; VGG4L, Double MHA pooling, fc1, fc2, the batch-norm
``b2`` embedding, preLayer, AM-Softmax) with its log-mel front end, its
training step (summed microbatch gradients, Adam with L2 weight decay) and
the verification score against an enrolled centroid.

Plain ``torch`` and ``numpy`` only: it imports nothing of the program and
takes nothing the program made. Parameters come as a dict keyed by the
program's state-dict names (``vgg.conv11.weight``, ``pooling.mha.query``,
...), holding the values the benchmark drew. The front end is computed in
float64; the network in the precision a :class:`Precision` names, which is
also how the control computes one step below it (TF32 operands for a float32
configuration, scaled float8 operands for a bfloat16 one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30
SAMPLE_RATE, N_FFT, WIN, HOP, N_MELS = 16000, 512, 400, 160, 80
PREEMPHASIS, RESCALE = 0.97, 32768.0


# ------------------------------------------------------------ precisions
def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """Per-tensor scaled float8, as float8 training scales each tensor by
    its largest magnitude."""
    xf = x.float()
    amax = xf.abs().max().clamp(min=1e-30)
    scale = top / amax
    return ((xf * scale).to(dtype).float() / scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Round an operand on the way in and its gradient on the way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


@dataclass(frozen=True)
class Precision:
    """How the network computes: ``conv_dtype`` for the VGG convolutions
    (bfloat16 rounds the conv, then adds the bias in bfloat16), and
    ``operand``, applied to every conv and matrix-product operand (None:
    exact in the compute type)."""

    name: str
    conv_dtype: torch.dtype
    conv_operand: Optional[Callable] = None
    mm_operand: Optional[Callable] = None

    def conv(self, x):
        return x if self.conv_operand is None else self.conv_operand(x)

    def mm(self, x):
        return x if self.mm_operand is None else self.mm_operand(x)


def _tf32_op(x):
    return _Operand.apply(x, _tf32_safe, _tf32_safe)


def _tf32_safe(x):
    return round_tf32(x) if x.dtype == torch.float32 else x


def _fp8_op(x):
    return _Operand.apply(x, lambda t: _round_fp8(t, torch.float8_e4m3fn, 448.0),
                          lambda g: _round_fp8(g, torch.float8_e5m2, 57344.0))


PRECISIONS = {
    "float32": Precision("float32", torch.float32),
    "tf32": Precision("tf32", torch.float32, _tf32_op, _tf32_op),
    "bfloat16": Precision("bfloat16", torch.bfloat16),
    "fp8": Precision("fp8", torch.bfloat16, _fp8_op, None),
}
# the control of each configured precision: the nearest step below it
CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8"}


# ------------------------------------------------------------ front end
def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3.0)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), lin)


def mel_filterbank() -> np.ndarray:
    """Slaney-scale triangles without area normalization, (n_bins, n_mels):
    librosa's ``melspectrogram(n_mels=80, fmin=0, fmax=sr/2, norm=None)``."""
    fft_f = np.linspace(0.0, SAMPLE_RATE / 2.0, 1 + N_FFT // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2.0), N_MELS + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).T


def analysis_window() -> np.ndarray:
    """The periodic Hamming window of 25 ms, centred in the 512-point frame."""
    n = np.arange(WIN)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / WIN)
    out = np.zeros(N_FFT)
    out[(N_FFT - WIN) // 2:(N_FFT - WIN) // 2 + WIN] = w
    return out


def frames_of(samples):
    return max(0, 1 + (int(samples) - N_FFT) // HOP)


class FrontEnd:
    def __init__(self, device):
        self.window = torch.tensor(analysis_window(), dtype=torch.float64, device=device)
        self.mel = torch.tensor(mel_filterbank(), dtype=torch.float64, device=device)

    def log_mel(self, pcm: torch.Tensor) -> torch.Tensor:
        """int16 PCM (N, S) -> log-mel (N, T, 80), float64: x32768 of the
        [-1, 1] wave, pre-emphasis 0.97, |rFFT| of Hamming frames of 25 ms
        every 10 ms (no centring), mel, log(max(1, .))."""
        y = pcm.to(torch.float64) / 32768.0 * RESCALE
        y = torch.cat([y[..., :1] * (1.0 - PREEMPHASIS), y[..., 1:] - PREEMPHASIS * y[..., :-1]], -1)
        t = frames_of(pcm.shape[-1])
        frames = y.unfold(-1, N_FFT, HOP)[..., :t, :] * self.window
        mag = torch.fft.rfft(frames, dim=-1).abs()
        return torch.log(torch.clamp(mag @ self.mel, min=1.0))


def normalize(feats: torch.Tensor, lengths: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """CMN: each utterance's mean over its valid frames removed; CMVN also
    divides by the standard deviation where it exceeds 0.01. Padding is
    zeroed."""
    if lengths is None:
        lengths = torch.full(feats.shape[:1], feats.shape[-2], device=feats.device)
    valid = (torch.arange(feats.shape[-2], device=feats.device) < lengths[:, None])[..., None]
    n = lengths.clamp(min=1)[:, None, None].to(feats.dtype)
    out = feats - torch.where(valid, feats, 0.0).sum(-2, keepdim=True) / n
    if mode == "cmvn":
        std = torch.sqrt(torch.where(valid, out * out, 0.0).sum(-2, keepdim=True) / n)
        out = out / torch.where(std > 0.01, std, torch.ones_like(std))
    elif mode != "cmn":
        raise ValueError(f"unknown normalization {mode!r}")
    return torch.where(valid, out, 0.0)


def normalize_np(raw: np.ndarray, mode: str) -> np.ndarray:
    """A features corpus file's raw (80, T) log-mel as normalized (T, 80)
    float32, over the whole utterance (the reference pipeline's
    ``data.py``: CMN, and for CMVN the standard deviation floored at 0.01)."""
    f = np.transpose(raw).astype(np.float32)
    out = f - np.mean(f, axis=0)
    if mode == "cmvn":
        std = np.std(f, axis=0)
        out = out / np.where(std > 0.01, std, 1.0)
    return out


# ---------------------------------------------------------------- model
def _mask_time(x, lengths, dim):
    if lengths is None:
        return x
    valid = torch.arange(x.shape[dim], device=x.device) < lengths[:, None]
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[dim] = x.shape[dim]
    return torch.where(valid.reshape(shape), x, torch.zeros((), dtype=x.dtype, device=x.device))


def vgg(P, x, lengths, prec: Precision, blocks: int = 4):
    """(B, T, 80) -> ((B, T', C * F'), lengths'): per block two 3x3 convs,
    each followed by ReLU and the length mask, then a 2x2 ceil-mode max pool."""
    h = _mask_time(x, lengths, 1)[:, None]
    dt = prec.conv_dtype
    for i in range(1, blocks + 1):
        for j in (1, 2):
            w, b = P[f"vgg.conv{i}{j}.weight"], P[f"vgg.conv{i}{j}.bias"]
            if dt == torch.float32:
                y = F.conv2d(prec.conv(h), prec.conv(w), b, padding=1)
            else:
                y = F.conv2d(prec.conv(h.to(dt)), prec.conv(w.to(dt)), None, padding=1)
                y = y + b.to(dt)[:, None, None]
            h = _mask_time(F.relu(y), lengths, 2)
        h = F.max_pool2d(h, 2, 2, ceil_mode=True)
        if lengths is not None:
            lengths = torch.div(lengths + 1, 2, rounding_mode="floor")
    b, c, t, f = h.shape
    return h.permute(0, 2, 1, 3).reshape(b, t, c * f).float(), lengths


def double_mha(P, ht, lengths, heads, prec: Precision, keep=None):
    """Per-head masked attention over time (scores scaled by 1/sqrt(heads)),
    then attention over the heads, with the dropped heads of ``keep``."""
    b, t, d = ht.shape
    ht4 = prec.mm(ht).reshape(b, t, heads, d // heads)
    q = prec.mm(P["pooling.mha.query"].t() / math.sqrt(heads))
    scores = torch.einsum("bthd,hd->bth", ht4, q)
    if lengths is not None:
        valid = (torch.arange(t, device=ht.device) < lengths[:, None])[..., None]
        scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=1, keepdim=True)
    e = torch.exp(scores - torch.where(m <= NEG_INF * 0.5, 0.0, m))
    if lengths is not None:
        e = torch.where(valid, e, 0.0)
    w = e / e.sum(dim=1, keepdim=True).clamp(min=1e-30)
    ctx = torch.einsum("bth,bthd->bhd", w, ht4)
    s = (prec.mm(ctx) @ prec.mm(P["pooling.head_att.att"]))[..., 0]
    if keep is not None:
        s = torch.where(keep.any(-1, keepdim=True), torch.where(keep, s, NEG_INF), s)
    return torch.einsum("bh,bhd->bd", torch.softmax(s, -1), ctx)


def _linear(P, name, x, prec):
    return prec.mm(x) @ prec.mm(P[f"{name}.weight"]).t() + P[f"{name}.bias"]


def embedding(P, feats, lengths, m, prec: Precision, keep=None, train=False, eps=1e-5):
    """The ``b2`` embedding of (B, T, 80) normalized features: batch
    statistics in training, the running ones otherwise."""
    ht, lens = vgg(P, feats, lengths, prec)
    pooled = double_mha(P, ht, lens, m["heads_number"], prec, keep)
    e2 = F.relu(_linear(P, "fc2", F.relu(_linear(P, "fc1", pooled, prec)), prec))
    if train:
        mean = e2.mean(0)
        var = ((e2 - mean) ** 2).mean(0)
    else:
        mean, var = P["b2.running_mean"], P["b2.running_var"]
    return (e2 - mean) * torch.rsqrt(var + eps) * P["b2.weight"] + P["b2.bias"]


def amsoftmax_loss(P, e, labels, m, prec: Precision):
    x = _linear(P, "pre_layer", e, prec)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
    w = P["amsoftmax.W"]
    w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True).clamp(min=1e-12)
    costh = prec.mm(x) @ prec.mm(w)
    logits = m["scalingFactor"] * (costh - m["marginFactor"] * F.one_hot(labels, costh.shape[-1]))
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]).mean()


# ----------------------------------------------------------- train step
def step_seed(seed: int, step: int) -> int:
    """Head dropout's draws for optimizer step ``step`` come from a CPU
    generator seeded so (the configuration's rule: seed + 17, then step)."""
    return int(np.random.SeedSequence([seed + 17, step]).generate_state(1, np.uint64)[0])


def head_keep(seed: int, step: int, groups: int, rows: int, heads: int, mask_prob: float):
    """Keep masks (rows, heads) of each microbatch: a head is dropped where a
    draw from U{0 .. int(1/mask_prob) - 1} is 0."""
    gen = torch.Generator().manual_seed(step_seed(seed, step))
    levels = int(1.0 / mask_prob)
    return [torch.randint(0, levels, (rows, heads), generator=gen) > 0 for _ in range(groups)]


def trainable(P: Dict[str, torch.Tensor]) -> List[str]:
    return [n for n in P if not n.startswith("b2.running_") and not n.endswith("num_batches_tracked")]


def train_steps(P0, batches, seed: int, m: dict, prec: Precision, front: FrontEnd,
                steps: int = 3):
    """``steps`` optimizer steps from ``P0`` over ``batches`` (each
    {waves (G, B, S) int16, lengths (G, B) samples, labels (G, B)}, or
    {inputs (G, B, T, 80) normalized features, lengths in frames, labels}): per
    microbatch the forward, the loss and its gradient, summed over the
    microbatches; then Adam with the weight decay added to the gradient.
    Returns each step's mean loss, the first step's gradient as the optimizer
    takes it, the raw first gradient, and the parameters after the last step."""
    names = trainable(P0)
    P = {n: t.detach().clone() for n, t in P0.items()}
    for n in names:
        P[n].requires_grad_(True)
    lr = float(np.float32(m["learning_rate"]))
    wd, b1, b2, eps = m["weight_decay"], 0.9, 0.999, 1e-8
    mom = {n: torch.zeros_like(P[n]) for n in names}
    vel = {n: torch.zeros_like(P[n]) for n in names}
    losses, grad1, raw1 = [], None, None
    for k in range(steps):
        batch = batches[k]
        lens, labels = batch["lengths"], batch["labels"]
        g, rows = labels.shape
        keeps = head_keep(seed, k, g, rows, m["heads_number"], m["mask_prob"])
        grads = {n: torch.zeros_like(P[n]) for n in names}
        total = 0.0
        for i in range(g):
            if "inputs" in batch:
                frames, feats = lens[i].long(), batch["inputs"][i].float()
            else:
                frames = torch.clamp(1 + torch.div(lens[i].long() - N_FFT, HOP,
                                                   rounding_mode="floor"), min=0)
                feats = normalize(front.log_mel(batch["waves"][i]), frames,
                                  m["normalization"]).float()
            e = embedding(P, feats, frames, m, prec, keeps[i].to(feats.device), train=True)
            loss = amsoftmax_loss(P, e, labels[i].long(), m, prec)
            for n, gr in zip(names, torch.autograd.grad(loss, [P[n] for n in names])):
                grads[n] += gr
            total += float(loss.detach())
        losses.append(total / g)
        with torch.no_grad():
            if k == 0:
                raw1 = {n: grads[n].clone() for n in names}
                grad1 = {n: grads[n] + wd * P[n] for n in names}
            t = k + 1
            for n in names:
                gn = grads[n] + wd * P[n]
                mom[n].mul_(b1).add_(gn, alpha=1 - b1)
                vel[n].mul_(b2).addcmul_(gn, gn, value=1 - b2)
                denom = (vel[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                P[n].addcdiv_(mom[n], denom, value=-lr / (1 - b1 ** t))
    return {"losses": losses, "grad1": grad1, "raw1": raw1,
            "params": {n: P[n].detach() for n in names}}


# -------------------------------------------------------------- serving
@torch.no_grad()
def embed_upload(P, pcm: torch.Tensor, m: dict, prec: Precision, front: FrontEnd) -> torch.Tensor:
    """One upload's embedding (int16 PCM (S,)), as the service computes it:
    normalized over the whole utterance, the eval-mode network, float64 out."""
    feats = normalize(front.log_mel(pcm[None]), None, m["normalization"]).float()
    return embedding(P, feats, None, m, prec)[0].double()


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x).clamp(min=1e-12)


def verify_score(emb: torch.Tensor, enrolled: List[torch.Tensor]) -> float:
    """Cosine of an upload's embedding and the speaker's centroid (the mean
    of the unit enrollment embeddings, renormalized)."""
    c = unit(torch.stack([unit(e) for e in enrolled]).mean(0))
    return float(emb @ c / (torch.linalg.vector_norm(emb).clamp(min=1e-8)
                            * torch.linalg.vector_norm(c).clamp(min=1e-8)))
