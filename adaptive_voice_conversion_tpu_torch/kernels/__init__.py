"""Hand-written Hopper kernels and their wrappers.

``griffin_lim`` holds the one kernel of the repository: the fused
Griffin-Lim iteration (``csrc/griffin_lim.cu``), its plain PyTorch version
and the hybrid warm-start / reflect-extend / polish schedule around it.
"""
