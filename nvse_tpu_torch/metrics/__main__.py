"""python -m nvse_tpu_torch.metrics <name> ... (metrics/cli.py)."""
from .cli import main

if __name__ == "__main__":
    main()
