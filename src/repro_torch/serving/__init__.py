"""Serving front end of the port: the continuous-batching session, its
samplers, the static batcher, SLO metrics and trace replay."""

from repro_torch.serving.api import DegradationPolicy, Request, ServeSession
from repro_torch.serving.errors import RequestRejected
from repro_torch.serving.metrics import (SLOClass, aggregate_requests,
                                         per_request_breakdown, request_record)
from repro_torch.serving.sampling import SamplingParams, make_row_sampler
from repro_torch.serving.scheduler import BatchServer
from repro_torch.serving.trace import (Trace, TraceRequest, burst_trace,
                                       chat_trace, doc_trace,
                                       mixed_tenant_trace, replay)

__all__ = ["BatchServer", "DegradationPolicy", "Request", "RequestRejected",
           "ServeSession", "SamplingParams", "make_row_sampler",
           "SLOClass", "aggregate_requests", "per_request_breakdown",
           "request_record", "Trace", "TraceRequest", "chat_trace",
           "doc_trace", "burst_trace", "mixed_tenant_trace", "replay"]
