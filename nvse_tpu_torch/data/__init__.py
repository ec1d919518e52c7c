from .audio_io import load_wav, read_wav, resample, write_wav
from .dataset import PrefetchLoader, SegmentDataset, get_dataset_filelist, parse_filelist_line
