from .audio_io import load_wav, read_wav, resample, write_wav
