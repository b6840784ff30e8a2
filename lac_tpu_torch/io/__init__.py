from .wav import read_wav, write_wav, write_wav_unchecked_samples

__all__ = ["read_wav", "write_wav", "write_wav_unchecked_samples"]
