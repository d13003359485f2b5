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
from gol_tpu_torch.models.largerthanlife import (
    BOSCO,
    CONWAY_LTL,
    MAJORITY_R4,
    LargerThanLifeRule,
)
from gol_tpu_torch.models.lenia import ORBIUM, LeniaRule
from gol_tpu_torch.models.patterns import PATTERNS, pattern_cells, stamp


def parse_rule(rulestring: str):
    """Parse a rulestring into its family's rule object: 'B3/S23'-style
    → LifeLikeRule; 'survival/birth/states' ('/2/3' = Brian's Brain) →
    GenerationsRule; 'R5,C0,M1,S33..57,B34..45,NM' (Golly LtL form) →
    LargerThanLifeRule; 'lenia:r=13,mu=0.15,sigma=0.015,dt=0.1' →
    LeniaRule. Empty → Conway. The single dispatch point for every
    rule-accepting surface (CLI --rule, server --rule, GOL_RULE)."""
    if not rulestring:
        return CONWAY
    errors = []
    for family in (LifeLikeRule, GenerationsRule, LargerThanLifeRule,
                   LeniaRule):
        try:
            return family(rulestring)
        except ValueError as e:
            errors.append(str(e))
    raise ValueError(
        f"unrecognised rulestring {rulestring!r}: not life-like "
        "('B3/S23'), Generations ('survival/birth/states', e.g. "
        "'/2/3'), Larger-than-Life ('R5,C0,M1,S33..57,B34..45,NM'), "
        "nor Lenia ('lenia:r=13,mu=0.15,sigma=0.015,dt=0.1'). "
        f"Family errors: {'; '.join(errors)}")


__all__ = [
    "BOSCO",
    "BRIANS_BRAIN",
    "CONWAY",
    "CONWAY_LTL",
    "DAY_AND_NIGHT",
    "HIGHLIFE",
    "MAJORITY_R4",
    "ORBIUM",
    "PATTERNS",
    "SEEDS",
    "STAR_WARS",
    "GenerationsRule",
    "GenerationsTorus",
    "LargerThanLifeRule",
    "LeniaRule",
    "LifeLikeRule",
    "parse_rule",
    "pattern_cells",
    "stamp",
]
