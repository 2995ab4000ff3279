"""EER, embedding extraction and trial scoring (JAX ``evaluation/``)."""

from .eer import cosine_scores, eer_exact, eer_reference, min_dcf
from .embeddings import (
    EmbeddingExtractor,
    pickle_feature_loader,
    score_trials,
    validate_eer,
    wav_feature_loader,
)

__all__ = [
    "cosine_scores",
    "eer_exact",
    "eer_reference",
    "min_dcf",
    "EmbeddingExtractor",
    "pickle_feature_loader",
    "score_trials",
    "validate_eer",
    "wav_feature_loader",
]
