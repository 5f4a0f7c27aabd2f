"""gpr_tpu — sparse Gaussian process regression on GPUs in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of OCaml-GPR
(mmottl/gpr): FITC/FIC sparse GPs and their variational variants, analytic
evidence gradients for all hyperparameters including inducing-point locations
(SPGP), the reference's five covariance families plus Matérn-3/2 and -5/2,
quasi-Newton/SGD/SMD evidence optimization,
posterior prediction and sampling — engineered for GEMM throughput, sharded over
device meshes with jax.sharding, and differentiated by jax.grad.
"""

__version__ = "0.1.0"

from . import kernels, models, numerics, optim
from .config import config

__all__ = ["kernels", "models", "numerics", "optim", "config", "__version__"]
