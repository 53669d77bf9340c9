from repro_torch.sparse.csr import (
    CSC,
    CSR,
    random_sparse_csc,
    random_sparse_csr,
    rows_to_ell,
    rows_to_ell_loop,
)

__all__ = [
    "CSR",
    "CSC",
    "random_sparse_csr",
    "random_sparse_csc",
    "rows_to_ell",
    "rows_to_ell_loop",
]
