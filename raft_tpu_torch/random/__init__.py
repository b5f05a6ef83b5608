"""Random state, draws and data generators (port of ``raft_tpu/random``;
reference raft/random/)."""

from raft_tpu_torch.random.generators import (make_blobs, make_regression,
                                               multi_variable_gaussian,
                                               rmat_rectangular_gen)
from raft_tpu_torch.random.rng import (GeneratorType, RngState, bernoulli,
                                       discrete, exponential, fill, gumbel,
                                       laplace, logistic, lognormal, normal,
                                       normal_int, normal_table, permute,
                                       rayleigh, sample_without_replacement,
                                       scaled_bernoulli, uniform, uniform_int)

__all__ = ["GeneratorType", "RngState", "bernoulli", "discrete",
           "exponential", "fill", "gumbel", "laplace", "logistic",
           "lognormal", "make_blobs", "make_regression",
           "multi_variable_gaussian", "normal", "normal_int", "normal_table",
           "permute", "rayleigh", "rmat_rectangular_gen",
           "sample_without_replacement", "scaled_bernoulli", "uniform",
           "uniform_int"]
