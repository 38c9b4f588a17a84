"""Event model, property maps, storage SPI and engine-facing stores (the
port's own copy of ``predictionio_tpu/data``)."""

from predictionio_tpu_torch.data.bimap import BiMap
from predictionio_tpu_torch.data.datamap import DataMap, PropertyMap
from predictionio_tpu_torch.data.event import Event

__all__ = ["DataMap", "PropertyMap", "Event", "BiMap"]
