"""PyTorch/CUDA port of centertrack_tpu for NVIDIA Hopper (H100).

The port stands alone: it imports torch, numpy and the standard library,
and nothing of the JAX package. Its public functions keep the JAX
package's layouts (NHWC maps, the (3, 3, Cin, Cout) DCN weight, the
interleaved (dy, dx) offsets) so that tests compare like with like.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; nothing falls back to the CPU when no GPU is found.
"""
