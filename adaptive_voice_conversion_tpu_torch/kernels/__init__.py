"""Hand-written Hopper kernels and their wrappers.

``griffin_lim`` holds the fused Griffin-Lim iteration
(``csrc/griffin_lim.cu``) and its plain PyTorch version; the schedules that
run it live in dsp/vocoder.py. ``hifigan`` holds the HiFi-GAN generator's
junction pass (``csrc/hifigan_junction.cu``) and its plain version; the
generator (models/hifigan.py) runs it between its convolutions.
"""
