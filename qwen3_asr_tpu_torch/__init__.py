"""PyTorch and CUDA port of ``qwen3_asr_tpu`` for NVIDIA Hopper (H100).

The module tree mirrors the JAX package so each module's counterpart is
easy to find. Attention runs through two CUDA kernels written by hand for
``sm_90a`` (``csrc/``); each has a plain PyTorch version beside it that the
wrappers take only for tensors on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
