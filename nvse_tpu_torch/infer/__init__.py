from .engine import InferenceEngine, resolve_filelist, run_inference
from .joint import run_joint_inference
