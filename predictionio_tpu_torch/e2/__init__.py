"""Host-side building blocks of the reference's e2 module (own copies)."""

from predictionio_tpu_torch.e2.vectorizer import BinaryVectorizer

__all__ = ["BinaryVectorizer"]
