"""Operator tools over the port's journals, checkpoints and fleet, each
run as `python -m gol_tpu_torch.tools.<name>`:

- `replay_audit`: verify a gol-journal/1 chain and replay it on the card,
  checking every recorded board digest;
- `ckpt_inspect`: list, verify and diff gol-ckpt/1 checkpoint directories
  (host only);
- `fleet_top`: a terminal dashboard over a federation router's telemetry;
- `load_smoke`: a concurrent create/attach/view/flag/destroy load, with
  an optional parked Subscribe audience, against any fleet server (by
  default the port's own, started in-process).

Their arguments, reports and exit codes are those of the JAX package's
`tools/replay_audit.py`, `tools/ckpt_inspect.py`, `tools/fleet_top.py`
and `tools/load_smoke.py`.
"""
