"""Featurizer and Griffin-Lim vocoder: numpy on the host, torch on tensors."""
