"""Operator tools over the port's journals, checkpoints and fleet, each
run as `python -m gol_tpu_torch.tools.<name>`:

- `replay_audit`: verify a gol-journal/1 chain and replay it on the card,
  checking every recorded board digest;
- `ckpt_inspect`: list, verify and diff gol-ckpt/1 checkpoint directories
  (host only);
- `fleet_top`: a terminal dashboard over a federation router's telemetry.

Their arguments, reports and exit codes are those of the JAX package's
`tools/replay_audit.py`, `tools/ckpt_inspect.py` and `tools/fleet_top.py`.
"""
