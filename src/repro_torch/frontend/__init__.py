"""Traced-torch frontend: plain PyTorch callables -> core IR graphs.

    from repro_torch import frontend

    graph = frontend.trace_model(fn, {"x": example_x}, params)

``importer`` exports the callable with ``torch.export`` and walks the
exported graph (direct ops + idiom raising); ``nn`` holds the recognized
torch spellings of the quantized idioms and the ``repro_torch`` custom
ops.

Port of ``repro.frontend``.
"""

from repro_torch.frontend import nn
from repro_torch.frontend.importer import (
    SUPPORTED_OPS,
    UnsupportedExportError,
    import_exported,
    trace_batched,
    trace_model,
)

__all__ = [
    "SUPPORTED_OPS",
    "UnsupportedExportError",
    "import_exported",
    "nn",
    "trace_batched",
    "trace_model",
]
