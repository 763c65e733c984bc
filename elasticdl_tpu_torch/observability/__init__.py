"""Observability for the PyTorch port (port of elasticdl_tpu/observability):
the metrics registry and its HTTP exposition, the gRPC interceptors, the
events journal, the cross-role trace, the device telemetry and the host
stack sampler, with the reference's metric names, event types, env knobs
and HTTP routes."""
