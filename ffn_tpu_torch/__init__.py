"""ffn_tpu_torch: the PyTorch/CUDA port of ffn_tpu for NVIDIA Hopper.

Mirrors ffn_tpu's layout and module names. It imports torch and never jax
or flax; ffn_tpu stays the reference it is tested against. The serial
inference path (Runner -> Canvas -> FloodFillEngine.step -> ConvStack3D)
runs on hand-written CUDA kernels (csrc/) on a CUDA device and on their
plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"
