from gol_tpu_torch.models.lifelike import (
    CONWAY,
    DAY_AND_NIGHT,
    HIGHLIFE,
    SEEDS,
    LifeLikeRule,
)


def parse_rule(rulestring: str) -> LifeLikeRule:
    """Parse a rulestring. The port carries the life-like family only
    ('B3/S23'-style; empty means Conway). Generations, Larger-than-Life
    and Lenia rulestrings raise NotImplementedError naming the ROADMAP
    items that port them; anything else raises ValueError."""
    if not rulestring:
        return CONWAY
    try:
        return LifeLikeRule(rulestring)
    except ValueError:
        pass
    other_family = (
        rulestring.startswith("lenia:")
        or rulestring.startswith("R")
        or rulestring.count("/") == 2
    )
    if other_family:
        raise NotImplementedError(
            f"rulestring {rulestring!r} is not life-like; gol_tpu_torch "
            "runs life-like rules only. Generations waits for ROADMAP "
            "A9, Larger-than-Life and Lenia for ROADMAP A12.")
    raise ValueError(
        f"unrecognised rulestring {rulestring!r}; want a life-like "
        "rule such as 'B3/S23'")


__all__ = [
    "CONWAY",
    "DAY_AND_NIGHT",
    "HIGHLIFE",
    "SEEDS",
    "LifeLikeRule",
    "parse_rule",
]
