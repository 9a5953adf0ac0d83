"""The port's ``make_x`` (glmnet's ``makeX``, ``admm_tpu_torch.data.makex``)
against the JAX package's on the same inputs: mixed dicts of numeric and
categorical columns, missing entries (NaN, None, empty strings),
``na_impute``, ``test=`` with levels unseen in training, and a plain 2-D
array.  Both return numpy arrays and column names; they must be equal
(NaN where NaN)."""
import numpy as np
import pytest
import torch

from admm_tpu.data.makex import make_x as jmake_x
from admm_tpu_torch import make_x

torch.set_num_threads(1)


def _cases():
    rng = np.random.default_rng(5)
    age = rng.normal(40, 10, 12)
    age[[2, 7]] = np.nan
    train = {"age": age,
             "city": ["a", "b", None, "c", "a", "", "b", "b", "c", "a", "c",
                      "a"],
             "score": [1, 2, None, 4, 5, 6, 7, 8, 9, 10, 11, 12],
             "code": ["1", "2", "1", "2", "3", "1", "2", "3", "1", "2", "3",
                      "1"]}
    test = {"age": [35.0, np.nan, 50.0],
            "city": ["d", "a", None],
            "score": [3, None, 1],
            "code": ["4", "1", "2"]}
    arr = rng.normal(size=(6, 3))
    arr[1, 2] = np.nan
    return {
        "mixed": (train, None, {}),
        "mixed_impute": (train, None, dict(na_impute=True)),
        "test_unseen_levels": (train, test, {}),
        "test_unseen_levels_impute": (train, test, dict(na_impute=True)),
        "array": (arr, None, {}),
        "array_impute": (arr, None, dict(na_impute=True)),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_make_x_matches_jax_package(case):
    train, test, kw = CASES[case]
    ref = jmake_x(train, test, **kw)
    got = make_x(train, test, **kw)
    assert len(got) == len(ref) == (2 if test is None else 3)
    assert got[-1] == ref[-1]                      # the column names
    for a, b in zip(got[:-1], ref[:-1]):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_make_x_takes_tensor_columns():
    """A tensor column is read back to the host: the result is the numpy
    column's."""
    train, _, _ = CASES["mixed_impute"]
    tensors = dict(train, age=torch.as_tensor(train["age"]))
    got = make_x(tensors, na_impute=True)
    ref = jmake_x(train, na_impute=True)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]


@pytest.mark.parametrize("case", ["bad_ndim", "test_columns"])
def test_make_x_refuses_as_jax_package(case):
    calls = {
        "bad_ndim": lambda f: f(np.zeros(4)),
        "test_columns": lambda f: f({"a": [1.0, 2.0]}, {"b": [1.0]}),
    }
    with pytest.raises(ValueError) as ref:
        calls[case](jmake_x)
    with pytest.raises(ValueError) as got:
        calls[case](make_x)
    assert str(got.value) == str(ref.value)
