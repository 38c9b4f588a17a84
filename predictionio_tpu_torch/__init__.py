"""predictionio_tpu_torch — the PyTorch and CUDA port of predictionio_tpu.

The JAX package ``predictionio_tpu`` stays beside it as the reference; this
package imports none of it. Module names match the JAX package's, so each
counterpart is easy to find. What is ported so far is the ALS
recommendation template's main path:

  - ``ops``         ALS trainer, serving index, batched SPD solve (CUDA kernel)
  - ``data``        event JSON codec, columnar events, JSON-lines event store
  - ``controller``  DASE base classes, params, engine, algorithm flavours
  - ``workflow``    train run, model blobs, engine loading, query server
  - ``models``      the recommendation template
  - ``tools``       ``python -m predictionio_tpu_torch.tools.cli``

Entry points take ``device`` and default to ``"cuda"``; they raise when
CUDA is absent unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
