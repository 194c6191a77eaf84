"""spartan2_tpu_torch: the PyTorch/CUDA port of spartan2_tpu for NVIDIA Hopper.

Same layout as the JAX package (field/ transcript/ polys/ r1cs/ sumcheck/
ec/ pcs/ frontend/ snark/ provider/ utils/) plus csrc/, the CUDA C++
sources of its kernels.  It imports torch, never jax, and nothing of
spartan2_tpu.
"""
