from .sdfa import Embed, PcaInversion, SpeakerEmbedding, SpeechDrivenAnimation, build_model

__all__ = ["Embed", "PcaInversion", "SpeakerEmbedding", "SpeechDrivenAnimation", "build_model"]
