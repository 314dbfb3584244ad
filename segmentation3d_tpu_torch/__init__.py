"""PyTorch/CUDA port of ``segmentation3d_tpu`` for NVIDIA Hopper GPUs.

Module paths mirror the JAX package's, so each counterpart is easy to find.
Entry points run on a CUDA device unless the caller asks for the CPU.
"""
