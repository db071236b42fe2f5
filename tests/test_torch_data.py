"""The port's numpy data layer against `repro.data`: the same seed gives
bit-identical arrays (exact equality, no tolerance)."""
import dataclasses

import numpy as np
import pytest

from repro import data as jdata
from repro.core import design_matrix as jdm
from repro_torch import data as tdata


@pytest.mark.parametrize("name", ["a9a", "real-sim", "gisette"])
def test_paper_like_bit_identical(name):
    a = jdata.paper_like(name, scale=0.01, seed=3, with_test=True)
    b = tdata.paper_like(name, scale=0.01, seed=3, with_test=True)
    for x, y in zip(a[:4], b[:4]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert dataclasses.asdict(a[4]) == dataclasses.asdict(b[4])


def test_make_classification_bit_identical():
    a = jdata.make_classification(200, 64, sparsity=0.7, corr=0.5, seed=9)
    b = tdata.make_classification(200, 64, sparsity=0.7, corr=0.5, seed=9)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_make_sparse_classification_bit_identical():
    (ca, ya, wa) = jdata.make_sparse_classification(300, 90, nnz_per_col=7,
                                                    seed=4)
    (cb, yb, wb) = tdata.make_sparse_classification(300, 90, nnz_per_col=7,
                                                    seed=4)
    assert np.array_equal(ca.col_rows, cb.col_rows)
    assert np.array_equal(ca.col_vals, cb.col_vals)
    assert ca.shape == cb.shape and ca.k_max == cb.k_max == 7
    assert np.array_equal(ya, yb) and np.array_equal(wa, wb)


@pytest.mark.parametrize("k_max", [None, 40])
def test_padded_csc_arrays_bit_identical(k_max):
    X, _, _ = jdata.make_classification(120, 50, sparsity=0.8, seed=2)
    csr = jdata.CSRMatrix.from_dense(X)
    a = jdm.padded_csc_arrays(csr.data, csr.indices, csr.indptr, csr.shape,
                              k_max=k_max)
    b = tdata.padded_csc_arrays(csr.data, csr.indices, csr.indptr,
                                csr.shape, k_max=k_max)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_libsvm_round_trip_bit_identical(tmp_path):
    X, y, _ = jdata.make_classification(60, 20, sparsity=0.7, seed=5)
    path = str(tmp_path / "d.svm")
    tdata.save_libsvm(path, X, y)
    for layout in ("dense", "csr", "padded_csc"):
        Xa, ya = jdata.load_libsvm(path, layout=layout)
        Xb, yb = tdata.load_libsvm(path, layout=layout)
        assert np.array_equal(ya, yb)
        if layout == "dense":
            assert np.array_equal(Xa, Xb)
        elif layout == "csr":
            for f in ("data", "indices", "indptr"):
                assert np.array_equal(getattr(Xa, f), getattr(Xb, f))
        else:
            assert np.array_equal(Xa.col_rows, Xb.col_rows)
            assert np.array_equal(Xa.col_vals, Xb.col_vals)
