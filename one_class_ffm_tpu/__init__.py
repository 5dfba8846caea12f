"""one_class_ffm_tpu — a one-class field-aware factorization machine trainer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++ trainer (johncreed/one-class-ffm): one-class collaborative filtering with
FFM/FM/MF models, solved by alternating block-coordinate Gauss-Newton with
conjugate gradient, where every unobserved (user, item) pair is a negative
with weight omega and imputed rating r, handled algebraically in
O(nnz + (m+n)k) without materializing the m x n matrix.

Layout:
  data/      text parsers (.ffm/.fm/.mf), dataset containers, prep pipelines
  ops/       sparse gather/scatter and positive-stream ops (XLA)
  models/    field-pair block layout and parameter state
  solver/    Gauss-Newton/CG block solver (the training engine)
  evalx/     full-catalog ranking evaluation (P@K, nDCG@K, ploss, AUC)
  parallel/  device mesh, sharding specs, distributed init
  utils/     logging, model text format, checkpointing, timers
"""

__version__ = "0.1.0"
