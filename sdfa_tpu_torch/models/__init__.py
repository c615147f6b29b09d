from .sdfa import PcaInversion, SpeakerEmbedding, SpeechDrivenAnimation, build_model

__all__ = ["PcaInversion", "SpeakerEmbedding", "SpeechDrivenAnimation", "build_model"]
