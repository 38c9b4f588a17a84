"""Model blobs for the model store (own copy of
``predictionio_tpu/workflow/model_io.py``; the same framing, so a blob the
JAX package wrote loads here).

Format v02 (``PIOTPU02``)::

    magic(8) ‖ zlib(pickle(models)) ‖ sha256(compressed)(32) ‖ len(compressed)(8, big-endian)

Legacy v01 blobs (``PIOTPU01``: ``magic ‖ zlib(pickle(models))``, no
footer) are still read; their corruption shows at decompress or unpickle
time and is wrapped in the same :class:`ModelIntegrityError`.

Models are pickled with every tensor already pulled to host numpy
(``make_persistent_model``), so blobs are device-agnostic. Loading goes
through ``convert.ModelUnpickler``, which maps the JAX package's model
classes to the port's.
"""

from __future__ import annotations

import hashlib
import io
import pickle
import struct
import zlib
from typing import Any

MAGIC = b"PIOTPU02"
MAGIC_V1 = b"PIOTPU01"

_FOOTER = struct.Struct(">32sQ")  # sha256(compressed) ‖ compressed length


class ModelIntegrityError(ValueError):
    """The blob is not an intact model artifact (bad magic, truncated, or
    checksum mismatch)."""


def serialize_models(models: list[Any]) -> bytes:
    payload = pickle.dumps(models, protocol=pickle.HIGHEST_PROTOCOL)
    compressed = zlib.compress(payload, level=1)
    footer = _FOOTER.pack(hashlib.sha256(compressed).digest(), len(compressed))
    return MAGIC + compressed + footer


def deserialize_models(blob: bytes) -> list[Any]:
    from predictionio_tpu_torch.convert import ModelUnpickler

    if blob.startswith(MAGIC):
        body = blob[len(MAGIC):]
        if len(body) < _FOOTER.size:
            raise ModelIntegrityError(
                f"model blob truncated: {len(body)} bytes cannot hold the "
                f"{_FOOTER.size}-byte integrity footer"
            )
        compressed, footer = body[: -_FOOTER.size], body[-_FOOTER.size:]
        digest, length = _FOOTER.unpack(footer)
        if len(compressed) != length:
            raise ModelIntegrityError(
                f"model blob truncated: footer says {length} payload bytes, "
                f"found {len(compressed)}"
            )
        if hashlib.sha256(compressed).digest() != digest:
            raise ModelIntegrityError("model blob corrupt: payload sha256 mismatch")
    elif blob.startswith(MAGIC_V1):
        # v01 has no footer: its corruption shows at decompress or unpickle
        try:
            return ModelUnpickler(io.BytesIO(zlib.decompress(blob[len(MAGIC_V1):]))).load()
        except (zlib.error, pickle.UnpicklingError, EOFError) as exc:
            raise ModelIntegrityError(
                f"model blob corrupt (legacy v01 format, no checksum): {exc}"
            ) from exc
    else:
        raise ModelIntegrityError("not a PIOTPU02 or PIOTPU01 model blob (bad magic)")
    return ModelUnpickler(io.BytesIO(zlib.decompress(compressed))).load()
