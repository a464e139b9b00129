"""MMSBM engine for trigenic genetic-interaction prediction, on the GPU.

A from-scratch, accelerator-first re-design of the capabilities of the reference
``AleixMT/TrigenicInteractionPredictor`` (a pure-Python, single-process EM
fitter for the tensorial Mixed-Membership Stochastic Block Model of
Godoy-Lorite et al., PNAS 2016, applied to the Kuzmin et al. 2018 trigenic
dataset).  See ``SURVEY.md`` for the layer map this package implements:

- L1 data layer          -> :mod:`trigenicinteractionpredictor_tpu.data`
- L2 model state         -> :mod:`trigenicinteractionpredictor_tpu.models`
- L3 EM engine           -> :mod:`trigenicinteractionpredictor_tpu.ops`
- L4 experiment driver   -> :mod:`trigenicinteractionpredictor_tpu.train`,
                            :mod:`trigenicinteractionpredictor_tpu.parallel`
- L5 evaluation          -> :mod:`trigenicinteractionpredictor_tpu.ops.metrics`,
                            :mod:`trigenicinteractionpredictor_tpu.eval`
- L6 CLI / config        -> :mod:`trigenicinteractionpredictor_tpu.cli`,
                            :mod:`trigenicinteractionpredictor_tpu.config`

The compute path is JAX compiled by XLA, plus one Pallas (Triton) kernel
for ensemble scoring; the hot EM sweep is expressed as factorized matmuls,
gathers and a segment-sum (never materializing the per-triplet K^3
responsibility tensor), and scales across a device mesh with
``shard_map`` + ``psum`` of sufficient statistics.
"""

__version__ = "0.1.0"

from trigenicinteractionpredictor_tpu.config import Config  # noqa: F401
