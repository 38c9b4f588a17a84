"""predictionio_tpu_torch — the PyTorch and CUDA port of predictionio_tpu.

The JAX package ``predictionio_tpu`` stays beside it as the reference; this
package imports none of it. Module names match the JAX package's, so each
counterpart is easy to find. What is ported so far is the main path of the
ALS recommendation template and of the sequential next-item template:

  - ``ops``         ALS trainer, serving index, batched SPD solve, attention
                    and the top-k endings (CUDA kernels under ``ops/csrc``)
  - ``data``        event JSON codec, columnar events, JSON-lines event store
  - ``e2``          the Markov chain of the reference's e2 module
  - ``controller``  DASE base classes, params, engine, algorithm flavours
  - ``workflow``    train run, model blobs, engine loading, query server
  - ``models``      the recommendation and sequential templates
  - ``tools``       ``python -m predictionio_tpu_torch.tools.cli``

Entry points take ``device`` and default to ``"cuda"``; they raise when
CUDA is absent unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
