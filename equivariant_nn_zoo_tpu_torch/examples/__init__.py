"""The port's examples: counterparts of the repository's ``examples/``
scripts (the MD calculator and integrator, constrained diffusion, the
irreps-content inference and the dataset conversion), each runnable with
``python -m equivariant_nn_zoo_tpu_torch.examples.<name>``."""
