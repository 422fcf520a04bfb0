"""FeTA in PyTorch for NVIDIA Hopper (H100).

The second implementation of the FeTA spectral graph transformer beside the
JAX package `feta_tmlr_tpu`, which stays the numerical reference. Module
names mirror the JAX package (`nn/feta.py` <-> `nn/feta.py`); plain tensor
code is PyTorch and the attention kernels are hand-written CUDA C++ under
`csrc/`, built with nvcc at first use (`ops/kernels/build.py`).

Entry points (`serve.Predictor`, model construction, the command-line
mains under `experiments/`) run on CUDA unless the caller passes
`device="cpu"` (`--device cpu`); `train.Trainer` runs on its model's
device.
On CPU tensors every kernel wrapper takes its plain PyTorch version.
"""

from feta_tmlr_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
