"""Hand-written Hopper kernels and their wrappers.

``griffin_lim`` holds the one kernel of the repository: the fused
Griffin-Lim iteration (``csrc/griffin_lim.cu``) and its plain PyTorch
version. The schedules that run it live in dsp/vocoder.py.
"""
