"""SpeakerEncoder, ContentEncoder, Decoder and AE as ``nn.Module``s whose
parameter names are the reference's state_dict keys."""
