from .engine import InferenceEngine, resolve_filelist, run_inference
