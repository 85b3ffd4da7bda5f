"""PyTorch and CUDA port of ``equivariant_nn_zoo_tpu``.

The JAX package beside it is the reference.  Module paths and class names
mirror it; parameters carry the JAX pytree's names.  Plain tensor code is
PyTorch, and each kernel the JAX package wrote in Pallas for the TPU is a
hand-written CUDA kernel for Hopper (``csrc/``), chosen by the device of the
tensors: CUDA tensors launch the kernel, CPU tensors run its plain PyTorch
version.  This package never imports jax.
"""
