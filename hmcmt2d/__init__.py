"""hmcmt2d — 2D magnetotelluric Bayesian (HMC) inversion in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
Julia package CUG-EMI/HMCMT2D (2D probabilistic MT inversion with Hamiltonian
Monte Carlo): finite-volume TE/TM forward modelling, adjoint gradients via
implicit differentiation, and a fully vectorised HMC sampler with chains
sharded over GPU device meshes.
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .mesh import TensorMesh2D, make_mesh, te_stencil, tm_stencil  # noqa: F401
