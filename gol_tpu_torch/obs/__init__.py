"""gol_tpu_torch.obs — the control plane's observability: the metrics
registry and catalogue, structured logging, the span tracer and the
flight recorder, and RPC latency quantiles. Copies of the parts of
`gol_tpu/obs/` that the wire codecs, the engine server and the remote
engine client use; the rest waits for ROADMAP A13.
"""

from gol_tpu_torch.obs import catalog  # declare every metric family up front
