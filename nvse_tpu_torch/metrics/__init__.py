"""Offline evaluation: the reference's metric suite (LSD, SNR, STOI / ESTOI,
MCD, F0, periodicity, PESQ-WB, ViSQOL, DNSMOS) as host numpy, the port's
copies of nvse_tpu/metrics/*; CREPE (metrics/crepe.py) and UTMOS
(metrics/utmos.py) run on the card. The CLI: python -m nvse_tpu_torch.metrics
<name> (metrics/cli.py); decode-and-score: python -m nvse_tpu_torch.metrics.quality;
the joint model's enhancement evaluation: python -m nvse_tpu_torch.metrics.enhance
and .joint_curve.
"""
from .dsp import (estoi, evaluate_f0_metrics, extract_f0, f0_metrics,
    f0_rmse, lsd, mcd, mcd_dtw, periodicity_metrics, si_snr, snr, stoi,
    yin_f0, yin_f0_conf)
from .mcep import mcd_sptk, mcd_sptk_dtw, mcep_frames, sptk_extract
from .world_f0 import dio_f0
from .dtw import dtw_distance, dtw_path
from .pesq import mnru, pesq_raw, pesq_wb
from .visqol import nsim, visqol, visqol_nsim
