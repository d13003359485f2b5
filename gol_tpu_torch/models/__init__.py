from gol_tpu_torch.models.lifelike import (
    CONWAY,
    DAY_AND_NIGHT,
    HIGHLIFE,
    SEEDS,
    LifeLikeRule,
)
from gol_tpu_torch.models.generations import (
    BRIANS_BRAIN,
    STAR_WARS,
    GenerationsRule,
    GenerationsTorus,
)


def parse_rule(rulestring: str):
    """Parse a rulestring: 'B3/S23'-style → LifeLikeRule,
    'survival/birth/states' ('/2/3' = Brian's Brain) → GenerationsRule;
    empty means Conway. Larger-than-Life and Lenia rulestrings raise
    NotImplementedError naming the ROADMAP item that ports them; anything
    else raises ValueError."""
    if not rulestring:
        return CONWAY
    errors = []
    for family in (LifeLikeRule, GenerationsRule):
        try:
            return family(rulestring)
        except ValueError as e:
            errors.append(str(e))
    if rulestring.startswith("lenia:") or rulestring.startswith("R"):
        raise NotImplementedError(
            f"rulestring {rulestring!r} is neither life-like nor "
            "Generations; gol_tpu_torch runs those two families. "
            "Larger-than-Life and Lenia wait for ROADMAP A12.")
    raise ValueError(
        f"unrecognised rulestring {rulestring!r}: not life-like "
        "('B3/S23') nor Generations ('survival/birth/states', e.g. "
        f"'/2/3'). Family errors: {'; '.join(errors)}")


__all__ = [
    "BRIANS_BRAIN",
    "CONWAY",
    "DAY_AND_NIGHT",
    "HIGHLIFE",
    "SEEDS",
    "STAR_WARS",
    "GenerationsRule",
    "GenerationsTorus",
    "LifeLikeRule",
    "parse_rule",
]
