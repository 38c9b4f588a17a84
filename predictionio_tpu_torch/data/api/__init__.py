"""Event-server plugins and ingestion statistics (port of
``predictionio_tpu/data/api``)."""
