"""RangeLDM on PyTorch and CUDA: the flagship latent sampling path of the
JAX package `rangeldm_tpu`, ported to one NVIDIA H100.

Tensors inside the package use the reference's torch layout (B, C,
W=azimuth, H=beams); images and point clouds at the public functions use
the JAX package's (B, H, W, C). The one TPU kernel on the path, fused
small-head attention, is a hand-written CUDA kernel (csrc/attention_fwd.cu)
built with nvcc at first use. Entry points run on CUDA unless the caller
passes device="cpu".
"""

__version__ = "0.1.0"
