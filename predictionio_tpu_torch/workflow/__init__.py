"""Train runs, model blobs, engine loading and the query server."""

from predictionio_tpu_torch.workflow.cleanup import CleanupFunctions
from predictionio_tpu_torch.workflow.context import WorkflowContext

__all__ = ["WorkflowContext", "CleanupFunctions"]
