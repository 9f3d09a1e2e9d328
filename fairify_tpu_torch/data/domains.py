"""Declarative attribute-domain specifications for every benchmark dataset.

Copy of ``fairify_tpu/data/domains.py`` (the port imports nothing of ``fairify_tpu``).

The reference hard-codes each dataset's ``range_dict`` inside 21 near-identical
driver scripts (e.g. ``src/GC/Verify-GC.py:39-60``, ``src/AC/Verify-AC.py:45-58``,
``src/BM/Verify-BM.py:30-46``, ``src/CP/Verify-CP.py:47-53``,
``src/DF/Verify-DF.py:52-83``).  Here each domain is one declarative spec;
driver variants (stress/relaxed/targeted/targeted2) are config deltas in
:mod:`fairify_tpu.verify.presets`.

Attribute order matters: it must match the column order of the loaded
dataframe (minus the label), because counterexamples and constraints are
positional in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class DomainSpec:
    """Integer box domain of one tabular dataset plus its label metadata."""

    name: str
    ranges: Dict[str, Tuple[int, int]]
    label: str
    # Attributes for which the domain is an integer lattice (all reference
    # datasets; DF's scaled columns are still encoded as integers by the
    # driver, src/DF/Verify-DF.py:178-179).
    columns: Tuple[str, ...] = field(default=None)

    def __post_init__(self):
        if self.columns is None:
            object.__setattr__(self, "columns", tuple(self.ranges.keys()))

    def override(self, **ranges) -> "DomainSpec":
        """New spec with some attribute ranges replaced (targeted queries)."""
        new = dict(self.ranges)
        for k, v in ranges.items():
            if k not in new:
                raise KeyError(f"{self.name}: unknown attribute {k}")
            new[k] = tuple(v)
        return replace(self, ranges=new)

    def lo_hi(self):
        import numpy as np

        lo = np.array([self.ranges[c][0] for c in self.columns], dtype=np.float32)
        hi = np.array([self.ranges[c][1] for c in self.columns], dtype=np.float32)
        return lo, hi


# German Credit — src/GC/Verify-GC.py:39-60 (20 features, label 'credit').
GERMAN = DomainSpec(
    name="german",
    label="credit",
    ranges={
        "status": (0, 2),
        "month": (0, 80),
        "credit_history": (0, 2),
        "purpose": (0, 9),
        "credit_amount": (0, 20000),
        "savings": (0, 2),
        "employment": (0, 2),
        "investment_as_income_percentage": (1, 4),
        "other_debtors": (0, 2),
        "residence_since": (1, 4),
        "property": (0, 2),
        "age": (0, 1),
        "installment_plans": (0, 2),
        "housing": (0, 2),
        "number_of_credits": (1, 4),
        "skill_level": (0, 3),
        "people_liable_for": (1, 2),
        "telephone": (0, 1),
        "foreign_worker": (0, 1),
        "sex": (0, 1),
    },
)

# Adult Census — src/AC/Verify-AC.py:45-58 (13 features, label 'income-per-year').
ADULT = DomainSpec(
    name="adult",
    label="income-per-year",
    ranges={
        "age": (10, 100),
        "workclass": (0, 6),
        "education": (0, 15),
        "education-num": (1, 16),
        "marital-status": (0, 6),
        "occupation": (0, 13),
        "relationship": (0, 5),
        "race": (0, 4),
        "sex": (0, 1),
        "capital-gain": (0, 19),
        "capital-loss": (0, 19),
        "hours-per-week": (1, 100),
        "native-country": (0, 40),
    },
)

# Bank Marketing — src/BM/Verify-BM.py:30-46 (16 features, label 'y').
BANK = DomainSpec(
    name="bank",
    label="y",
    ranges={
        "age": (0, 1),
        "job": (0, 10),
        "marital": (0, 2),
        "education": (0, 6),
        "default": (0, 1),
        "housing": (0, 1),
        "loan": (0, 1),
        "contact": (0, 1),
        "month": (0, 11),
        "day_of_week": (0, 6),
        "duration": (0, 5000),
        "emp.var.rate": (-3, 1),
        "campaign": (1, 50),
        "pdays": (0, 999),
        "previous": (0, 7),
        "poutcome": (0, 2),
    },
)

# Compas — src/CP/Verify-CP.py:47-53 (6 features, label 'score_factor').
COMPAS = DomainSpec(
    name="compass",
    label="score_factor",
    ranges={
        "Two_yr_Recidivism": (0, 1),
        "Number_of_Priors": (0, 38),
        "Age": (0, 1),
        "Race": (0, 1),
        "Female": (0, 1),
        "Misdemeanor": (0, 1),
    },
)

# Compas, 12-feature encoding (``data/compass/compass.csv``) — the input
# layout of the reference's CP-2..10 / aCP-1-Old zoo models, which its
# committed CP driver never runs (it filters to CP-11,
# ``src/CP/Verify-CP.py:91``; the 12-input family is exercised only by the
# ``experimentData/task4`` node runs).  Ranges profiled from the CSV; the
# anonymized columns d..l are small ordinal scores.
COMPAS12 = DomainSpec(
    name="compass12",
    label="label",
    ranges={
        "sex": (0, 1),
        "age": (0, 2),
        "race": (0, 1),
        "d": (0, 20),
        "e": (1, 10),
        "f": (0, 38),
        "g": (0, 1),
        "h": (0, 1),
        "i": (0, 1),
        "j": (1, 10),
        "k": (1, 10),
        "l": (0, 38),
    },
)

# Default Credit — src/DF/Verify-DF.py:52-83 (30 features).
DEFAULT_CREDIT = DomainSpec(
    name="default",
    label="default.payment.next.month",
    ranges={
        "LIMIT_BAL": (10000, 1000000),
        "AGE": (21, 79),
        "PAY_1": (0, 1),
        "PAY_2": (0, 1),
        "PAY_3": (0, 1),
        "PAY_4": (0, 1),
        "PAY_5": (0, 1),
        "PAY_6": (0, 1),
        "BILL_AMT1": (-165580, 964511),
        "BILL_AMT2": (-69777, 983931),
        "BILL_AMT3": (-157264, 1664089),
        "BILL_AMT4": (-170000, 891586),
        "BILL_AMT5": (-81334, 927171),
        "BILL_AMT6": (-339603, 961664),
        "PAY_AMT1": (0, 873552),
        "PAY_AMT2": (0, 1684259),
        "PAY_AMT3": (0, 896040),
        "PAY_AMT4": (0, 621000),
        "PAY_AMT5": (0, 426529),
        "PAY_AMT6": (0, 528666),
        "SEX_2": (0, 1),
        "EDUCATION_1": (0, 1),
        "EDUCATION_2": (0, 1),
        "EDUCATION_3": (0, 1),
        "EDUCATION_4": (0, 1),
        "EDUCATION_5": (0, 1),
        "EDUCATION_6": (0, 1),
        "MARRIAGE_1": (0, 1),
        "MARRIAGE_2": (0, 1),
        "MARRIAGE_3": (0, 1),
    },
)

# LSAC bar passage — asset shipped but never wired up by the reference
# (``data/lsac``, SURVEY.md §2.4); ranges match ``loaders.load_lsac``'s
# integer encoding (UGPA in tenths, LSAT in half-points ×2, race1
# label-encoded alphabetically).
LSAC = DomainSpec(
    name="lsac",
    label="pass_bar",
    ranges={
        "decile1b": (1, 10),
        "decile3": (1, 10),
        "lsat": (22, 96),
        "ugpa": (15, 39),
        "fulltime": (1, 2),
        "fam_inc": (1, 5),
        "male": (0, 1),
        "race1": (0, 4),
        "tier": (1, 6),
    },
)

DOMAINS = {
    "german": GERMAN,
    "adult": ADULT,
    "bank": BANK,
    "compass": COMPAS,
    "compass12": COMPAS12,
    "default": DEFAULT_CREDIT,
    "lsac": LSAC,
}


def get_domain(name: str) -> DomainSpec:
    return DOMAINS[name]
