"""Least-squares Helmert (7-parameter similarity) estimation."""

from icepy4d_tpu_torch.least_squares.absolute_orientation import (  # noqa: F401
    compute_residuals,
    estimate_similarity_least_squares,
    get_T_from_params,
)
