"""gol_tpu_torch.obs — the control plane's observability: the metrics
registry and catalogue, structured logging, the span tracer and the
flight recorder, RPC latency quantiles and the fleet-health cache, and
step signatures, device memory, the audit queue, the usage meter, run
reports, the telemetry exporter, tsdb and alerts, the profiler and the
HTTP endpoints. Copies of `gol_tpu/obs/`; the halo statistics wait for
ROADMAP A5.
"""

from gol_tpu_torch.obs import catalog  # declare every metric family up front
