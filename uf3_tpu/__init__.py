"""
uf3_tpu: a JAX framework for Ultra-Fast Force Fields (UF3).

Energies are linear combinations of cubic B-spline basis functions over pair
distances (2-body) and tensor-product B-splines over triplet distances
(3-body), plus per-element 1-body offsets.  Training is regularized linear
least squares over DFT energies/forces; inference is a jit-compiled
calculator / MD engine running on the GPU through JAX/XLA.

Layout (capability parity with the reference package ``uf3``):
  data/            atoms, elements, composition, geometry, parsers, analysis
  representation/  knot sequences, B-spline basis config, featurization
  ops/             JAX device kernels (splines, neighbors, features, MD)
  regression/      regularizers, weighted linear model, cutoff optimization
  forcefield/      calculator, MD engine, LAMMPS export, properties
  parallel/        device-mesh sharding helpers
  util/            json io, yaml config, compile cache, tracing, plotting
"""

__version__ = "0.1.0"
