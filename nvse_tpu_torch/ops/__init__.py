from .lstm import lstm_scan, lstm_scan_fused, lstm_scan_fused_plain
from .spectral import (
    hann_window,
    inverse_mel,
    istft_ri,
    mel_spectrogram,
    mel_spectrogram_np,
)
