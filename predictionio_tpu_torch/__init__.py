"""predictionio_tpu_torch — the PyTorch and CUDA port of predictionio_tpu.

The JAX package ``predictionio_tpu`` stays beside it as the reference; this
package imports none of it. Module names match the JAX package's, so each
counterpart is easy to find. What is ported so far is every template's path
from event ingest to query, and the offline verbs:

  - ``ops``         ALS trainer, serving index, batched SPD solve, attention
                    and the top-k endings (CUDA kernels under ``ops/csrc``)
  - ``data``        the event codec, the storage locator and its memory,
                    sqlite, jsonl and localfs backends, the event stores
                    templates read through, the event server and webhooks
  - ``e2``          the Markov chain of the reference's e2 module
  - ``controller``  DASE base classes, params, engine, algorithm flavours
  - ``workflow``    train and evaluation runs, model blobs, engine loading,
                    query server, offline batch prediction
  - ``eval``        metrics, evaluator, params grids, the prefix-caching engine
  - ``tuning``      the fold×params evaluation grid, its ledger and workers
  - ``obs``         the metrics registry and the step profiler
  - ``resilience``  the retry policy and circuit breaker
  - ``models``      the seven templates
  - ``tools``       ``python -m predictionio_tpu_torch.tools.cli``, import
                    and export

Entry points take ``device`` and default to ``"cuda"``; they raise when
CUDA is absent unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
