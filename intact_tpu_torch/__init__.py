"""intact_tpu_torch — the PyTorch/CUDA port of intact_tpu for NVIDIA Hopper.

The JAX package `intact_tpu` is the reference; this package imports nothing
from it (and never imports jax). Public functions keep the reference's
layouts so the two can be compared like with like: attention tensors are
[B, T, H, D], dense kernels [in, out], per-layer block weights stacked
[L, ...], the K/V cache [L, B, P, KVH, D] with RoPE already applied to K,
images [B, K, H, W, 3].

Entry points (`Pi0Policy`, the models' `init`, the serving wrappers of
`serve.policy_wrapper.make_policy_wrapper`) run on the CUDA device unless
the caller passes `device="cpu"`; without a CUDA device and without an
explicit "cpu" they raise.
"""
