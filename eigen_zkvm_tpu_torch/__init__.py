"""PyTorch/CUDA port of eigen_zkvm_tpu.

The package mirrors `eigen_zkvm_tpu/` (`ops/`, `hash/`, `stark/`, `utils/`),
imports `torch` and never `jax`, and imports nothing of `eigen_zkvm_tpu`:
what it needs of that package's host code (the starkinfo compiler, the PIL
types and builder, the transcript, the Merkle checks, the serializer and
the verifier) it keeps as its own copies.  It proves the GL eSTARK
device-resident: the commits, the constraint VM, the Q split, the openings
and the FRI fold chain run as tensor code on the engine's device (the
current CUDA device unless the caller asks for the CPU).  Hand-written
CUDA kernels for Hopper (`csrc/`) carry the Goldilocks NTT and the
Poseidon-GL permutation; every kernel has a plain PyTorch twin that runs
for CPU tensors.
"""
