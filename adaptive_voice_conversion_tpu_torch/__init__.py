"""AdaIN-VC one-shot voice conversion in PyTorch, for NVIDIA Hopper GPUs.

Counterpart of ``adaptive_voice_conversion_tpu`` (the JAX package, which
stays the reference): every subpackage and module keeps its JAX name, so a
module's counterpart sits at the same relative path. The fused Griffin-Lim
iteration, a Pallas kernel there, is a hand-written CUDA kernel here
(``csrc/griffin_lim.cu``, wrapped by ``kernels/griffin_lim.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
