"""Checkpoint/restore: async snapshots, integrity-verified manifests,
resumable and crash-recoverable runs — the counterpart of
`gol_tpu/ckpt/`, interchangeable with it in both directions: a
checkpoint written by either package restores in the other to the
identical board and turn.

Every checkpoint is a payload `.npz` (the format `Engine.load_checkpoint`
speaks) plus a `gol-ckpt/1` JSON manifest recording run identity, turn,
rule, board geometry, representation, and the SHA-256 of the payload,
published payload-first / manifest-last with tmp+fsync+rename at each
step, so a crash at any instant leaves either a durable checkpoint or
removable garbage.

Layout of a checkpoint directory (GOL_CKPT / --checkpoint):

    ckpt-000000001024.npz    payload (published first)
    ckpt-000000001024.json   manifest (published second — durability bit)

Modules:

    manifest.py   schema, atomic write/read/verify, directory listing
    writer.py     background double-buffered writer (off the hot loop),
                  and the fleet's shared writer pool
    retention.py  keep-last + keep-every-K-turns GC, crash-safe
    restore.py    resolve dir|manifest|legacy-npz -> verified engine state
    reshard.py    geometry contract + host-side canonical repack

Env / flags (read at run time, like every GOL_* knob):

    GOL_CKPT=<dir>                --checkpoint DIR    checkpoint directory
    GOL_CKPT_EVERY_TURNS=<n>      --ckpt-every N      manifest ckpt cadence
    GOL_CKPT_KEEP=<n>             --ckpt-keep N       retention: keep last N
    GOL_CKPT_KEEP_EVERY=<turns>                       retention: pin every K
    GOL_CKPT_EVERY=<seconds>                          legacy single-file autosave
"""

from gol_tpu_torch.ckpt.manifest import (  # noqa: F401
    CheckpointIntegrityError,
    MANIFEST_SCHEMA,
    latest_checkpoint,
    list_checkpoints,
    read_manifest,
    verify_manifest,
    write_manifest,
)
from gol_tpu_torch.ckpt.reshard import (  # noqa: F401
    GeometryMismatch,
    load_canonical,
    reshard_into,
    restore_delta,
)
from gol_tpu_torch.ckpt.restore import resolve, restore_engine  # noqa: F401
from gol_tpu_torch.ckpt.retention import RetentionPolicy  # noqa: F401
from gol_tpu_torch.ckpt.writer import (  # noqa: F401
    CheckpointWriter,
    CheckpointWriterPool,
    Snapshot,
)

# Env names (single source; engine/server/main all import these).
CKPT_DIR_ENV = "GOL_CKPT"
CKPT_EVERY_TURNS_ENV = "GOL_CKPT_EVERY_TURNS"
CKPT_KEEP_ENV = "GOL_CKPT_KEEP"
CKPT_KEEP_EVERY_ENV = "GOL_CKPT_KEEP_EVERY"
CKPT_KEEP_DEFAULT = 3


def export_flags(args) -> None:
    """The CLI's and the server's --checkpoint, --ckpt-every, --ckpt-keep,
    --journal and --journal-digest-every as their GOL_* env (those given
    and non-zero): the engine reads them at run start, like every GOL_*
    knob."""
    import os

    from gol_tpu_torch import journal

    for value, name in ((args.checkpoint, CKPT_DIR_ENV),
                        (args.ckpt_every, CKPT_EVERY_TURNS_ENV),
                        (args.ckpt_keep, CKPT_KEEP_ENV),
                        (args.journal, journal.JOURNAL_ENV),
                        (args.journal_digest_every, journal.DIGEST_EVERY_ENV)):
        if value:
            os.environ[name] = str(value)
