from .griffin_lim import griffin_lim, random_phase
from .lstm import (
    lstm_scan,
    lstm_scan_bidir,
    lstm_scan_bidir_plain,
    lstm_scan_bidir2,
    lstm_scan_bidir2_plain,
    lstm_scan_fused,
    lstm_scan_fused_plain,
    lstm_scan_plain,
    lstm_scan_stateful,
    lstm_scan_stateful_plain,
)
from .spectral import (
    StreamingOLA,
    amp_pha_spectrum,
    hann_window,
    inverse_mel,
    istft_frames,
    istft_ri,
    mel_spectrogram,
    mel_spectrogram_np,
    stft_ri,
)
from .tcn import tcn_block_tail, tcn_block_tail_kernel, tcn_block_tail_plain
