"""gol_tpu_torch.obs — the control plane's observability: the metrics
registry and catalogue, structured logging, the span tracer and the
flight recorder, RPC latency quantiles and the fleet-health cache, and
the fleet's step signatures, audit queue, usage meter and run reports.
Copies of the parts of `gol_tpu/obs/` that the wire codecs, the engine
server, the remote engine client and the fleet use; the rest waits for
ROADMAP A13.
"""

from gol_tpu_torch.obs import catalog  # declare every metric family up front
