"""RangeLDM on PyTorch and CUDA: latent sampling, conditional generation
(4x beam densification and azimuth-sector inpainting), latent-diffusion
training of the flagship and conditional models, the LiDAR data loader,
the scores of generated scans (MMD, JSD, FRD with RangeNet++, IoU,
accuracy, MAE, chamfer) and the release parity gate of the JAX package
`rangeldm_tpu`, ported to one NVIDIA H100.

Tensors inside the package use the reference's torch layout (B, C,
W=azimuth, H=beams); images and point clouds at the public functions use
the JAX package's (B, H, W, C). The TPU kernels on the paths, fused
small-head attention forward and backward, are hand-written CUDA kernels
(csrc/attention_fwd.cu, csrc/attention_bwd.cu) built with nvcc at first
use. Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
