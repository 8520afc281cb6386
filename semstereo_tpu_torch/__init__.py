"""SemStereo in PyTorch for NVIDIA Hopper (H100).

A port of ``semstereo_tpu`` (JAX/TPU), which stays the numerical reference.
Public ops keep the JAX package's channels-last layouts: images and features
[B, H, W, C], volumes [B, D, H, W, C], hypothesis maps [B, K, H, W].  The
3x3x3 volume convs and the /8 cosine group-wise correlation volume run in
kernels written by hand for sm_90a (``csrc/``), built with nvcc at first use.
On CPU tensors every kernel wrapper uses its plain PyTorch version.
"""

from semstereo_tpu_torch.models import SemStereo, __models__, build_model

__all__ = ["SemStereo", "__models__", "build_model"]
