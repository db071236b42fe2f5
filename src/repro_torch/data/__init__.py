"""Data substrate of the port: LIBSVM parsing and synthetic datasets (numpy)."""
from repro_torch.data.libsvm import (CSRMatrix, PaddedCSC, csr_to_padded_csc,
                                     load_libsvm, padded_csc_arrays,
                                     save_libsvm, save_libsvm_csr)
from repro_torch.data.synthetic import (PAPER_DATASETS, make_classification,
                                        make_sparse_classification,
                                        paper_like, train_accuracy)

__all__ = [
    "load_libsvm", "save_libsvm", "save_libsvm_csr", "make_classification",
    "paper_like", "PAPER_DATASETS", "CSRMatrix", "PaddedCSC",
    "csr_to_padded_csc", "padded_csc_arrays", "make_sparse_classification",
    "train_accuracy",
]
