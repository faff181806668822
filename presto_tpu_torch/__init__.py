"""presto_tpu_torch — the presto_tpu SQL engine on PyTorch and CUDA.

A port of `presto_tpu` (the JAX/TPU reference, which stays in this
repository unchanged) that keeps its data contracts and its SQL
surface: the same text goes in and the same rows come out.  Columns are
torch tensors on the session's device; the reference's Pallas kernels
become CUDA kernels written for Hopper (`presto_tpu_torch/csrc`).

`connect(catalog)` runs on `cuda:0`; pass `device="cpu"` to run on the
CPU.  Without a CUDA device and without `device="cpu"` it raises.
"""

from presto_tpu_torch.session import Session, connect

__version__ = "0.1.0"

__all__ = ["Session", "connect", "__version__"]
