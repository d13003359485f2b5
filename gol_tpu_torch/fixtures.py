"""Metadata about the seeded golden fixtures (`images/`, `check/`), a copy
of `gol_tpu/fixtures.py`.

The 512² fixture board's ash is period-2 from well before turn 10⁴ (the
analog of the reference board's 5565/5567 oscillation,
`Local/count_test.go:43-49`). Gates on the alive count past the end of
`check/alive/512x512.csv` share these constants; re-derive them with the
port's host oracle, `gol_tpu_torch.native.step_torus`, after reseeding
the fixture (`tests/make_fixtures.py`).
"""

# (even-turn alive count, odd-turn alive count) of the settled ash.
ASH_512_EVEN = 7527
ASH_512_ODD = 7525

# The ash is provably settled by here; gates keyed to ASH_512_* must not
# fire below this turn.
ASH_512_SETTLED_BY = 10_000


def ash_512_alive(turn: int) -> int:
    """Expected alive count of the settled 512² fixture at `turn`
    (valid for turn >= ASH_512_SETTLED_BY)."""
    return ASH_512_EVEN if turn % 2 == 0 else ASH_512_ODD
