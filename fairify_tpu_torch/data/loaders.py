"""Dataset loaders: CSV → encoded numpy matrices with a fixed seed-42 split.

Port of ``fairify_tpu/data/loaders.py`` in numpy and the ``csv`` module
only (the JAX package's loaders read with pandas and encode with sklearn).
Each loader gives the JAX loader's ``X_train``, ``y_train``, ``X_test`` and
``y_test`` on the same file, value for value, by reproducing what those
libraries do:

* ``pandas.read_csv`` — per-column type inference (int64, else float64,
  else bool, else str), pandas' default NA tokens plus the loader's
  ``na_values`` as missing, blank lines skipped (:func:`read_table`);
* ``train_test_split(test_size=0.15, random_state=42)`` — the test rows are
  the first ``ceil(0.15 n)`` entries of ``RandomState(42).permutation(n)``,
  the train rows the rest, in that order (:func:`split`);
* ``LabelEncoder`` — the index into the sorted unique values;
* ``KBinsDiscretizer(n_bins=20, encode="ordinal", strategy="uniform")`` —
  sklearn 1.9.0's rule (:func:`kbins_uniform`);
* ``MinMaxScaler`` (a zero range maps to 0) and ``OneHotEncoder(drop=
  "first")`` (sorted categories) — :func:`minmax_scale`, :func:`one_hot`.

``LoadedDataset.df`` is an ordered column → array mapping in place of the
DataFrame; ``feature_columns`` and ``X`` keep their meaning.  ``encoders``
holds each encoder's fitted parameters (classes, bin edges, categories,
ranges) as arrays.

Data files are read from a configurable root: ``$FAIRIFY_TPU_DATA_ROOT``,
else ``reference/data`` under the working directory (the reference
checkout's ``data``).  ``bank-additional-full.csv`` is missing from the
reference checkout; the bank loader falls back to ``bank-additional.csv``
and records which file it used.
"""
from __future__ import annotations

import csv
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

DEFAULT_DATA_ROOT = os.environ.get("FAIRIFY_TPU_DATA_ROOT", os.path.join("reference", "data"))
SPLIT_SEED = 42  # utils/verif_utils.py:187 — fixed across every loader
TEST_FRACTION = 0.15

# pandas.read_csv's default missing-value tokens (keep_default_na=True).
PANDAS_NA = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})

Frame = Dict[str, np.ndarray]


@dataclass
class LoadedDataset:
    name: str
    df: Frame
    X_train: np.ndarray
    y_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray
    label: str
    encoders: Dict[str, object] = field(default_factory=dict)
    notes: Dict[str, str] = field(default_factory=dict)

    @property
    def feature_columns(self):
        return [c for c in self.df if c != self.label]

    @property
    def X(self) -> np.ndarray:
        return np.concatenate([self.X_train, self.X_test], axis=0)


# ---------------------------------------------------------------------------
# pandas and sklearn, the parts the loaders use
# ---------------------------------------------------------------------------


def _is_int(tok: str) -> bool:
    t = tok[1:] if tok[:1] in "+-" else tok
    return t.isdigit() and t.isascii()


def _is_float(tok: str) -> bool:
    try:
        float(tok)
    except ValueError:
        return False
    return "_" not in tok


def _column(tokens: List[Optional[str]]) -> np.ndarray:
    """One parsed column (``None`` = missing), typed as pandas infers it."""
    vals = [t for t in tokens if t is not None]
    missing = len(vals) < len(tokens)
    if vals and all(_is_int(t) for t in vals):
        if not missing:
            return np.array([int(t) for t in tokens], dtype=np.int64)
        return np.array([np.nan if t is None else int(t) for t in tokens], dtype=np.float64)
    if vals and all(_is_float(t) for t in vals):
        return np.array([np.nan if t is None else float(t) for t in tokens], dtype=np.float64)
    if vals and not missing and all(t in _TRUE or t in _FALSE for t in vals):
        return np.array([t in _TRUE for t in tokens], dtype=bool)
    if not vals:
        return np.full(len(tokens), np.nan)
    out = np.empty(len(tokens), dtype=object)
    out[:] = [np.nan if t is None else t for t in tokens]
    return out


def read_table(path, sep: str = ",", names=None, skip_first: bool = False,
               skipinitialspace: bool = False, na_values=()) -> Frame:
    """``pandas.read_csv`` for the loaders' files: the header row names the
    columns unless ``names`` is given (``skip_first`` drops a first line
    that ``header=0`` would replace by ``names``); quoted fields unquoted;
    ``na_values`` and pandas' default NA tokens are missing (NaN)."""
    na = PANDAS_NA | set(na_values)
    with open(path, newline="") as fp:
        rows = [r for r in csv.reader(fp, delimiter=sep, skipinitialspace=skipinitialspace)
                if r and any(r)]
    if names is None or skip_first:
        header, rows = rows[0], rows[1:]
        names = list(header) if names is None else names
    names = list(names)
    for r in rows:
        if len(r) != len(names):
            raise ValueError(f"{path}: a row of {len(r)} fields, expected {len(names)}")
    return {c: _column([None if r[j] in na else r[j] for r in rows])
            for j, c in enumerate(names)}


def isna(a: np.ndarray) -> np.ndarray:
    if a.dtype == object:
        return np.array([isinstance(v, float) and math.isnan(v) for v in a], dtype=bool)
    if a.dtype.kind == "f":
        return np.isnan(a)
    return np.zeros(a.shape[0], dtype=bool)


def dropna(df: Frame) -> Frame:
    """Rows without a missing value in any column."""
    keep = ~np.any([isna(a) for a in df.values()], axis=0)
    return {c: a[keep] for c, a in df.items()}


def concat(*frames: Frame) -> Frame:
    """Rows of the frames one after the other (pandas' dtype promotion:
    int and float give float, anything with str gives object)."""
    out = {}
    for c in frames[0]:
        parts = [f[c] for f in frames]
        if any(p.dtype == object for p in parts):
            out[c] = np.concatenate([p.astype(object) for p in parts])
        else:
            out[c] = np.concatenate(parts)
    return out


def mapped(a: np.ndarray, mapping: dict, keep: bool) -> np.ndarray:
    """``Series.map(mapping)`` (unmapped → NaN) or, with ``keep``,
    ``Series.replace(mapping)`` (unmapped kept)."""
    vals = [mapping.get(v, v if keep else np.nan) for v in a.tolist()]
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in vals):
        return np.array(vals, dtype=np.int64)
    if all(isinstance(v, (int, float, np.integer, np.floating)) for v in vals):
        return np.array(vals, dtype=np.float64)
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out


def label_encode(a: np.ndarray):
    """``LabelEncoder().fit_transform``: ``(codes int64, classes)``, the
    codes indexing the sorted unique values."""
    classes = np.array(sorted(set(a.tolist())), dtype=a.dtype)
    index = {v: i for i, v in enumerate(classes.tolist())}
    return np.array([index[v] for v in a.tolist()], dtype=np.int64), classes


def kbins_uniform(a: np.ndarray, n_bins: int = 20):
    """``KBinsDiscretizer(n_bins, encode="ordinal", strategy="uniform")``'s
    ``fit_transform`` as in sklearn 1.9.0: edges ``linspace(min, max,
    n_bins + 1)`` and the bin ``searchsorted(edges[1:-1], x, side="right")``,
    with no tolerance added to ``x`` (earlier releases digitized
    ``x + 1e-8 + 1e-5 |x|``); a constant column bins to 0.  Returns
    ``(bins float64, edges)``."""
    x = a.astype(np.float64)
    lo, hi = x.min(), x.max()
    if lo == hi:
        return np.zeros_like(x), np.array([-np.inf, np.inf])
    edges = np.linspace(lo, hi, n_bins + 1)
    return np.searchsorted(edges[1:-1], x, side="right").astype(np.float64), edges


def minmax_scale(cols: List[np.ndarray]):
    """``MinMaxScaler().fit_transform`` column by column in sklearn's
    arithmetic: ``x * scale + min_`` with ``scale = 1 / range`` (a range
    below ``10 eps`` counts as 1, so a constant column maps to 0) and
    ``min_ = 0 - data_min * scale``.  Returns ``(columns, (data_min,
    data_max))``."""
    X = np.stack([c.astype(np.float64) for c in cols], axis=1)
    dmin, dmax = np.nanmin(X, axis=0), np.nanmax(X, axis=0)
    rng = dmax - dmin
    rng[rng < 10 * np.finfo(rng.dtype).eps] = 1.0
    scale = 1 / rng
    X *= scale
    X += 0 - dmin * scale
    return [X[:, j] for j in range(X.shape[1])], (dmin, dmax)


def one_hot(a: np.ndarray, name: str):
    """``OneHotEncoder(drop="first", sparse_output=False)`` of one column:
    the sorted categories but the first, each a float64 0/1 column named
    ``<name>_<category>``.  Returns ``(columns {name: array}, categories)``."""
    cats = np.unique(a)
    return {f"{name}_{c}": (a == c).astype(np.float64) for c in cats[1:]}, cats


def get_dummies(df: Frame, columns, prefix_sep: str = "=") -> Frame:
    """``pd.get_dummies(df, columns=...)``: the other columns first, then per
    listed column one bool column per sorted category."""
    out = {c: a for c, a in df.items() if c not in columns}
    for c in columns:
        for cat in sorted(set(df[c].tolist())):
            out[f"{c}{prefix_sep}{cat}"] = df[c] == cat
    return out


def mode(a: np.ndarray):
    """``Series.mode(dropna=True)[0]``: the most frequent value, the
    smallest of a tie."""
    vals = [v for v, na in zip(a.tolist(), isna(a)) if not na]
    counts: Dict[object, int] = {}
    for v in vals:
        counts[v] = counts.get(v, 0) + 1
    top = max(counts.values())
    return sorted(v for v, n in counts.items() if n == top)[0]


def fillna(a: np.ndarray, value) -> np.ndarray:
    out = a.copy()
    out[isna(a)] = value
    return out


def split(df: Frame, label: str):
    """``train_test_split(X, y, test_size=0.15, random_state=42)`` of the
    frame's features (every column but ``label``, float64) and label
    (int): the test rows are the first ``ceil(0.15 n)`` of
    ``RandomState(42).permutation(n)``, the train rows the rest."""
    X = np.stack([df[c].astype(np.float64) for c in df if c != label], axis=1)
    y = df[label].astype("int")
    n = X.shape[0]
    n_test = math.ceil(TEST_FRACTION * n)
    perm = np.random.RandomState(SPLIT_SEED).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return X[train], y[train], X[test], y[test]


def _root(root) -> Path:
    return Path(root or DEFAULT_DATA_ROOT)


def _encode(df: Frame, cols, encoders: dict) -> None:
    for f in cols:
        df[f], encoders[f] = label_encode(df[f])


def _dataset(name: str, df: Frame, label: str, encoders=None, notes=None) -> LoadedDataset:
    X_train, y_train, X_test, y_test = split(df, label)
    return LoadedDataset(name, df, X_train, y_train, X_test, y_test, label,
                         encoders or {}, notes or {})


# ---------------------------------------------------------------------------
# German Credit  (utils/verif_utils.py:193-241 + utils/standard_data.py:4-65)
# ---------------------------------------------------------------------------

_GERMAN_COLUMNS = [
    "status", "month", "credit_history", "purpose", "credit_amount", "savings",
    "employment", "investment_as_income_percentage", "personal_status",
    "other_debtors", "residence_since", "property", "age", "installment_plans",
    "housing", "number_of_credits", "skill_level", "people_liable_for",
    "telephone", "foreign_worker", "credit",
]

_GERMAN_GROUPS = {
    "credit_history": {"A30": "None/Paid", "A31": "None/Paid", "A32": "None/Paid",
                       "A33": "Delay", "A34": "Other"},
    "savings": {"A61": "<500", "A62": "<500", "A63": "500+", "A64": "500+",
                "A65": "Unknown/None"},
    "employment": {"A71": "Unemployed", "A72": "1-4 years", "A73": "1-4 years",
                   "A74": "4+ years", "A75": "4+ years"},
    "status": {"A11": "<200", "A12": "<200", "A13": "200+", "A14": "None"},
}


def load_german(root=None) -> LoadedDataset:
    df = read_table(_root(root) / "german" / "german.data", sep=" ", names=_GERMAN_COLUMNS)
    df["age"] = (df["age"] >= 26).astype(float)  # binarized PA, verif_utils.py:204
    # utils/standard_data.py:4-65: sex from personal_status (1 = male),
    # coarse credit-history/savings/employment/status groups, label 1/2 → 1/0.
    df["sex"] = mapped(df["personal_status"], {"A91": 1, "A93": 1, "A94": 1, "A92": 0,
                                               "A95": 0}, keep=False)
    for col, mapping in _GERMAN_GROUPS.items():
        df[col] = mapped(df[col], mapping, keep=False)
    df["credit"] = mapped(df["credit"], {1: 1, 2: 0}, keep=True)
    del df["personal_status"]
    encoders: Dict[str, object] = {}
    _encode(df, ["status", "credit_history", "purpose", "savings", "employment",
                 "other_debtors", "property", "installment_plans", "housing",
                 "skill_level", "telephone", "foreign_worker"], encoders)
    return _dataset("german", df, "credit", encoders)


# ---------------------------------------------------------------------------
# Adult Census, label-encoded 13-feature form  (utils/verif_utils.py:119-190)
# ---------------------------------------------------------------------------

_ADULT_COLUMNS = [
    "age", "workclass", "fnlwgt", "education", "education-num", "marital-status",
    "occupation", "relationship", "race", "sex", "capital-gain", "capital-loss",
    "hours-per-week", "native-country", "income-per-year",
]


def _adult_raw(root) -> Frame:
    """adult.test's rows, then adult.data's (the test file's first line is
    replaced by the column names)."""
    base = _root(root) / "adult"
    train = read_table(base / "adult.data", names=_ADULT_COLUMNS, skipinitialspace=True,
                       na_values=["?"])
    test = read_table(base / "adult.test", names=_ADULT_COLUMNS, skip_first=True,
                      skipinitialspace=True, na_values=["?"])
    return concat(test, train)


def _favorable(a: np.ndarray, values) -> np.ndarray:
    return np.where(np.isin(a.astype(object), list(values)), 1, 0)


def load_adult(root=None) -> LoadedDataset:
    """The AC scripts' loader (``load_adult_ac1``): label-encode categoricals,
    20-bin-discretize capital gain/loss, binary label on >50K."""
    df = _adult_raw(root)
    del df["fnlwgt"]
    df = dropna(df)
    encoders: Dict[str, object] = {}
    _encode(df, ["sex", "workclass", "education", "marital-status", "occupation",
                 "relationship", "native-country", "race"], encoders)
    for f in ["capital-gain", "capital-loss"]:
        df[f], encoders[f] = kbins_uniform(df[f])
    label = "income-per-year"
    df[label] = _favorable(df[label], (">50K", ">50K."))
    return _dataset("adult", df, label, encoders)


def load_adult_adf(root=None) -> LoadedDataset:
    """The ADF variant (``utils/verif_utils.py:46-116``): :func:`load_adult`'s
    13-feature encoding with the label one-hot (two columns)."""
    base = load("adult", root)
    y_train = np.stack([1 - base.y_train, base.y_train], axis=1).astype("int")
    y_test = np.stack([1 - base.y_test, base.y_test], axis=1).astype("int")
    return LoadedDataset("adult_adf", base.df, base.X_train, y_train, base.X_test, y_test,
                         base.label, base.encoders, dict(base.notes, label_encoding="one-hot"))


# ---------------------------------------------------------------------------
# Bank Marketing  (utils/verif_utils.py:309-366)
# ---------------------------------------------------------------------------

_BANK_COLUMNS = [
    "age", "job", "marital", "education", "default", "housing", "loan", "contact",
    "month", "day_of_week", "duration", "emp.var.rate", "campaign", "pdays",
    "previous", "poutcome", "y",
]


def load_bank(root=None) -> LoadedDataset:
    base = _root(root) / "bank"
    notes = {}
    path = base / "bank-additional-full.csv"
    if not path.is_file():  # missing from the reference checkout
        path = base / "bank-additional.csv"
        notes["data_file"] = "bank-additional.csv (full file unavailable)"
    df = dropna(read_table(path, sep=";", na_values=["unknown"]))
    df["age"] = (df["age"] >= 25).astype(float)  # binarized PA, verif_utils.py:325
    encoders: Dict[str, object] = {}
    _encode(df, ["job", "marital", "education", "default", "housing", "loan", "contact",
                 "month", "day_of_week", "poutcome"], encoders)
    df = {c: df[c] for c in _BANK_COLUMNS}
    df["y"] = _favorable(df["y"], ("yes",))
    return _dataset("bank", df, "y", encoders, notes)


# ---------------------------------------------------------------------------
# Compas  (utils/verif_utils.py:243-265)
# ---------------------------------------------------------------------------


def load_compass(root=None) -> LoadedDataset:
    df = read_table(_root(root) / "compass" / "compas_preprocessed_full.csv")
    encoders: Dict[str, object] = {}
    _encode(df, ["Two_yr_Recidivism", "Number_of_Priors", "Age", "Race", "Female",
                 "Misdemeanor"], encoders)
    return _dataset("compass", df, "score_factor", encoders)


def load_compass12(root=None) -> LoadedDataset:
    """Compas in the 12-feature encoding of ``data/compass/compass.csv``
    (the reference's 12-input CP models); every column arrives
    integer-encoded."""
    return _dataset("compass12", read_table(_root(root) / "compass" / "compass.csv"), "label")


# ---------------------------------------------------------------------------
# Default Credit  (utils/verif_utils.py:267-307)
# ---------------------------------------------------------------------------


def load_default(root=None) -> LoadedDataset:
    raw = read_table(_root(root) / "default" / "default.csv")
    df = {("PAY_1" if c == "PAY_0" else c): a for c, a in raw.items() if c != "ID"}
    cat_oh = ["SEX", "EDUCATION", "MARRIAGE"]
    encoded, cats = {}, []
    for c in cat_oh:
        cols, cat = one_hot(df[c], c)
        encoded.update(cols)
        cats.append(cat)
    df = {c: a for c, a in df.items() if c not in cat_oh}
    df.update(encoded)
    mms_cols = ["PAY_1", "PAY_2", "PAY_3", "PAY_4", "PAY_5", "PAY_6"]
    scaled, ranges = minmax_scale([df[c] for c in mms_cols])
    df.update(zip(mms_cols, scaled))
    return _dataset("default", df, "default.payment.next.month",
                    {"onehot": cats, "minmax": ranges})


# ---------------------------------------------------------------------------
# Adult, one-hot 42-feature form  (utils/verif_utils.py:369-482; used by the
# experimentData notebooks rather than the main scripts)
# ---------------------------------------------------------------------------

_ADULT_ONEHOT_COLUMNS = [
    "education=Assoc-acdm", "education=Assoc-voc", "education=Bachelors",
    "education=Doctorate", "education=HS-grad", "education=Masters",
    "education=Preschool", "education=Prof-school", "education=elementary_school",
    "sex=Female", "marital-status=Married", "marital-status=Separated",
    "marital-status=Widowed", "occupation=Adm-clerical", "occupation=Armed-Forces",
    "occupation=Craft-repair", "occupation=Exec-managerial", "occupation=Farming-fishing",
    "occupation=Handlers-cleaners", "occupation=Machine-op-inspct",
    "occupation=Priv-house-serv", "occupation=Prof-specialty",
    "occupation=Protective-serv", "occupation=Sales", "occupation=Tech-support",
    "occupation=Transport-moving", "relationship=Husband", "relationship=Not-in-family",
    "relationship=Other-relative", "relationship=Own-child", "relationship=Unmarried",
    "relationship=Wife", "workclass=Govt_employees", "workclass=Never-worked",
    "workclass=Private", "workclass=Self_employed", "workclass=Without-pay",
    "race", "age", "capital-gain", "capital-loss", "hours-per-week", "income-per-year",
]


def load_adult_onehot(root=None) -> LoadedDataset:
    df = _adult_raw(root)
    for col in ["workclass", "occupation", "native-country"]:
        df[col] = fillna(df[col], mode(df[col]))
    replace = {
        "education": [{"11th": "HS-grad", "10th": "HS-grad", "9th": "HS-grad",
                       "12th": "HS-grad"},
                      {"1st-4th": "elementary_school", "5th-6th": "elementary_school",
                       "7th-8th": "elementary_school"}],
        "marital-status": [{"Married-spouse-absent": "Married",
                            "Married-civ-spouse": "Married", "Married-AF-spouse": "Married",
                            "Separated": "Separated", "Divorced": "Separated"}],
        "workclass": [{"Self-emp-not-inc": "Self_employed", "Self-emp-inc": "Self_employed",
                       "Local-gov": "Govt_employees", "State-gov": "Govt_employees",
                       "Federal-gov": "Govt_employees"}],
    }
    for col, maps in replace.items():
        for m in maps:
            df[col] = mapped(df[col], m, keep=True)
    df = dropna({c: a for c, a in df.items() if c not in ("education-num", "fnlwgt")})
    df = get_dummies(df, ["sex", "workclass", "education", "marital-status", "occupation",
                          "relationship", "native-country"])
    df["race"], race_classes = label_encode(df["race"])
    df = {c: df[c] for c in _ADULT_ONEHOT_COLUMNS if c in df}
    label = "income-per-year"
    df[label] = _favorable(df[label], (">50K", ">50K."))
    df = {c: a.astype(int) if a.dtype == bool else a for c, a in df.items()}
    return _dataset("adult_onehot", df, label, {"race": race_classes})


# ---------------------------------------------------------------------------
# LSAC (Law School Admission Council bar-passage study): a 9-feature
# integer-encodable subset with the bar-passage label.
# ---------------------------------------------------------------------------


def load_lsac(root=None) -> LoadedDataset:
    raw = read_table(_root(root) / "lsac" / "lsac.csv")
    cols = ["decile1b", "decile3", "lsat", "ugpa", "fulltime", "fam_inc", "male", "race1",
            "tier"]
    label = "pass_bar"
    df = dropna({c: raw[c] for c in cols + [label]})
    # UGPA in tenths, LSAT in half-points: scaled to an integer lattice
    # (np.round: half to even, as pandas' Series.round).
    df["ugpa"] = np.round(df["ugpa"] * 10)
    df["lsat"] = np.round(df["lsat"] * 2)
    df["race1"], race_classes = label_encode(df["race1"])
    df = {c: a.astype(int) for c, a in df.items()}
    return _dataset("lsac", df, label, {"race1": race_classes})


LOADERS = {
    "german": load_german,
    "adult": load_adult,
    "bank": load_bank,
    "compass": load_compass,
    "compass12": load_compass12,
    "default": load_default,
    "adult_onehot": load_adult_onehot,
    "adult_adf": load_adult_adf,
    "lsac": load_lsac,
}

_CACHE: Dict[str, LoadedDataset] = {}


def load(name: str, root=None, cache: bool = True) -> LoadedDataset:
    key = f"{name}:{root or DEFAULT_DATA_ROOT}"
    if cache and key in _CACHE:
        return _CACHE[key]
    ds = LOADERS[name](root)
    if cache:
        _CACHE[key] = ds
    return ds
