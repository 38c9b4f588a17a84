"""Session / next-item template on PyTorch (port of
``predictionio_tpu.models.sequential``)."""
