"""Serving front end of the port: the continuous-batching session and its
samplers."""

from repro_torch.serving.api import DegradationPolicy, Request, ServeSession
from repro_torch.serving.errors import RequestRejected
from repro_torch.serving.sampling import SamplingParams, make_row_sampler

__all__ = ["DegradationPolicy", "Request", "RequestRejected", "SamplingParams",
           "ServeSession", "make_row_sampler"]
