"""Observability helpers of the port (counterpart of
``fgnn_tpu/utils``)."""

from .debug import check_finite, deterministic, nan_debug
from .logging import MetricsWriter, init_logger
from .profiling import StepTimer, annotate, device_memory_stats, trace
from .types import str2bool

__all__ = ["init_logger", "MetricsWriter", "str2bool", "StepTimer",
           "annotate", "device_memory_stats", "trace", "nan_debug",
           "check_finite", "deterministic"]
