"""Serving stack of the port (reference: ``repro/serving``): the engine, the
deadline-aware scheduler, multi-model tenancy over one page pool, the
metrics and the Chrome-trace tracer."""
from repro_torch.serving.engine import (Request, ServingEngine,
                                        SlotCheckpoint, sample_token,
                                        sample_token_batch)
from repro_torch.serving.metrics import (MetricsRecorder, RequestRecord,
                                         multi_summary, validate)
from repro_torch.serving.sched import Scheduler, StreamSpec
from repro_torch.serving.tenancy import MultiScheduler
from repro_torch.serving.trace import Stopwatch, Tracer

__all__ = ["ServingEngine", "Request", "SlotCheckpoint", "sample_token",
           "sample_token_batch", "Scheduler", "StreamSpec", "MultiScheduler",
           "MetricsRecorder", "RequestRecord", "multi_summary", "validate",
           "Tracer", "Stopwatch"]
