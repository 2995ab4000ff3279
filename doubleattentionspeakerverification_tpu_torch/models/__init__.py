"""VGG encoder, attention pooling and the embedding trunk (JAX ``models/``).

The JAX package's functional API becomes ``nn.Module``s here, so its names
map onto the port's: ``speaker_classifier_apply`` is
``SpeakerClassifier.classify``, ``get_embedding`` is
``SpeakerClassifier.forward`` (eval mode), ``vgg_apply`` is ``VGG``, and
``init_speaker_classifier`` is ``init_parameters`` on a
``SpeakerClassifier``. ``ModelState`` has no counterpart by design: ``b2``'s
running statistics are the module's buffers.
"""

from .classifier import SpeakerClassifier, get_alignments
from .init import init_parameters
from .vgg import VGG, vgg_output_dim

__all__ = [
    "SpeakerClassifier",
    "get_alignments",
    "init_parameters",
    "VGG",
    "vgg_output_dim",
]
