"""ALS recommendation template on PyTorch (port of
``predictionio_tpu.models.recommendation``)."""
