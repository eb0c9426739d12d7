"""PyTorch/CUDA port of the DeepSC-GAN transceiver for NVIDIA Hopper.

A package of its own beside the JAX reference package: it imports `torch`
and never JAX, flax, or anything of the JAX package. Module names mirror
the JAX package's. Entry points run on the CUDA device unless the caller
names another (`utils.device.resolve_device`); the CPU path exists for the
parity tests, where every hand-written kernel is replaced by its plain
PyTorch version.
"""
