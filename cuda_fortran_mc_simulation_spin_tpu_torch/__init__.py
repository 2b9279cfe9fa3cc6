"""PyTorch + CUDA port of the spin-lattice Monte Carlo framework.

A second package beside ``cuda_fortran_mc_simulation_spin_tpu`` (the JAX
package, which stays the reference).  Its tree mirrors the JAX one, so
every module here has one reference module.  Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path is a CUDA kernel written
by hand for Hopper (``csrc/``), built with nvcc into ``.build/`` on first
use and bound with ctypes, with a plain PyTorch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from cuda_fortran_mc_simulation_spin_tpu_torch.config import RunConfig  # noqa: F401
