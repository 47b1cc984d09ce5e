"""ffn_tpu_torch: the PyTorch/CUDA port of ffn_tpu for NVIDIA Hopper. It
mirrors ffn_tpu's layout, imports torch and never jax, flax or ffn_tpu
(the reference it is tested against); every path runs on hand-written CUDA
kernels (csrc/) on a card and on their plain PyTorch versions on the CPU.
"""

__version__ = "0.1.0"
