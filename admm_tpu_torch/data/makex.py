"""Design-matrix construction from mixed-type columns (glmnet's
``makeX``; counterpart of ``admm_tpu/data/makex.py``).

glmnet exports ``makeX(train, test, na.impute=...)`` to turn a data
frame with factor columns and missing values into the numeric matrix
its fitters need; this is the numpy equivalent for users arriving from
there.  Input is a dict of named columns (or any 2D numeric array,
passed through imputation only):

    X, names = make_x({"age": [31, 42, np.nan], "city": ["a", "b", "a"]},
                      na_impute=True)

* CATEGORICAL columns (string/object dtype) expand to a FULL indicator
  set — one 0/1 column per level, named ``col:level`` (glmnet keeps
  every level, leaving identifiability to the penalty).
* ``na_impute=True`` replaces missing numeric entries with the TRAIN
  column mean, and missing categorical entries with each level's train
  frequency (the mean of its indicator column) — exactly glmnet's
  ``na.impute`` semantics, since a missing factor row is an NA row of
  indicators.  Without it, missing entries propagate as NaN (glmnet's
  default, where the fitter then errors on non-finite input).
* ``test=`` builds a SECOND matrix over the same columns: levels are
  the union seen in train and test (glmnet row-binds the frames), but
  imputation means come from TRAIN ONLY.

Returns ``(X, names)`` — or ``(X, X_test, names)`` with ``test=`` —
as numpy arrays: this is host-side preprocessing, and its output goes
into any entry point (a tensor column is read back to the host first).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..interop import to_numpy


def _is_missing(col):
    """Elementwise missing mask for an object/string column (None,
    np.nan, or empty string count as missing)."""
    out = np.zeros(len(col), bool)
    for i, v in enumerate(col):
        out[i] = v is None or (isinstance(v, float) and np.isnan(v)) \
            or (isinstance(v, str) and v == "")
    return out


def _columns(data):
    """Normalize input to an ordered list of (name, 1d-array)."""
    if isinstance(data, dict):
        return [(str(k), to_numpy(v).ravel()) for k, v in data.items()]
    a = to_numpy(data)
    if a.ndim != 2:
        raise ValueError("make_x takes a dict of columns or a 2D array")
    return [(f"V{j}", a[:, j]) for j in range(a.shape[1])]


def make_x(train, test=None, *, na_impute: bool = False):
    """Build numeric design matrices from mixed-type columns (module
    docstring; glmnet's ``makeX``)."""
    tr_cols = _columns(train)
    te_cols = _columns(test) if test is not None else None
    if te_cols is not None:
        if [n for n, _ in te_cols] != [n for n, _ in tr_cols]:
            raise ValueError("test must have the same columns as train")

    def _as_numeric(col):
        """A column is numeric when every NON-MISSING entry is a
        number (a Python list with None arrives as dtype object — it
        must still be treated as numeric-with-missing, not one-hot
        encoded); numeric-LOOKING strings stay categorical, as in
        glmnet's data-frame semantics.  Returns the float64 column
        with NaNs for missing, or None if categorical."""
        if col.dtype.kind in "fiub":
            return col.astype(np.float64)
        if col.dtype.kind != "O":
            return None
        out = np.empty(len(col), np.float64)
        for i, v in enumerate(col):
            if v is None or (isinstance(v, float) and np.isnan(v)):
                out[i] = np.nan
            elif isinstance(v, (int, float, np.integer, np.floating)) \
                    and not isinstance(v, bool):
                out[i] = float(v)
            else:
                return None
        return out

    names: list = []
    tr_out: list = []
    te_out: list = []
    for j, (name, col) in enumerate(tr_cols):
        tcol = te_cols[j][1] if te_cols is not None else None
        v = _as_numeric(col)
        vt = None if tcol is None else _as_numeric(tcol)
        numeric = v is not None and (tcol is None or vt is not None)
        if numeric:
            if na_impute:
                mu = np.nanmean(v) if np.isfinite(v).any() else 0.0
                v = np.where(np.isnan(v), mu, v)
                if vt is not None:
                    vt = np.where(np.isnan(vt), mu, vt)
            names.append(name)
            tr_out.append(v)
            if vt is not None:
                te_out.append(vt)
            continue
        # Categorical: full indicator set over train(+test) levels.
        miss = _is_missing(col)
        miss_t = None if tcol is None else _is_missing(tcol)
        seen = [v for v, m in zip(col, miss) if not m]
        if tcol is not None:
            seen += [v for v, m in zip(tcol, miss_t) if not m]
        levels = sorted({str(v) for v in seen})
        svals = np.array([str(v) for v in col])
        stest = None if tcol is None else np.array(
            [str(v) for v in tcol])
        for lev in levels:
            ind = (svals == lev).astype(np.float64)
            ind[miss] = np.nan
            if na_impute:
                mu = (np.nanmean(ind)
                      if np.isfinite(ind).any() else 0.0)
                ind = np.where(np.isnan(ind), mu, ind)
            names.append(f"{name}:{lev}")
            tr_out.append(ind)
            if stest is not None:
                it = (stest == lev).astype(np.float64)
                it[miss_t] = np.nan
                if na_impute:
                    it = np.where(np.isnan(it), mu, it)
                te_out.append(it)

    X = np.column_stack(tr_out)
    if te_cols is None:
        return X, names
    return X, np.column_stack(te_out), names
