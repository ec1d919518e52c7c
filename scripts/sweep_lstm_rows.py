#!/usr/bin/env python3
"""Time the port's fused-LSTM CUDA kernel at each rows-per-block instance.

    python3 scripts/sweep_lstm_rows.py

At the two BSRNN-M B=8 shapes (time: 272 rows x 1024 steps; band: 8192
rows x 34 steps; C = H = 128), float32 and bfloat16, forces each of the
kernel's row-tile sizes in turn (ops/lstm.py `_ROWS_PER_BLOCK`) and
prints one JSON line per (shape, dtype) with the CUDA-event time of each
and the size `_rows_per_block` picks. Needs a CUDA GPU.
"""
import json
import math
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("sweep_lstm_rows: needs a CUDA GPU")
    sys.path.insert(0, REPO)
    from nvse_tpu_torch import resolve_device
    from nvse_tpu_torch.ops import lstm

    resolve_device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    picker = lstm._rows_per_block
    C = H = 128
    for label, R, T in (("time", 272, 1024), ("band", 8192, 34)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(0)
            b = 1.0 / math.sqrt(H)
            x = torch.randn(R, T, C, generator=g)
            ws = [torch.empty(s).uniform_(-b, b, generator=g) for s in
                  [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
            args = [t.to("cuda", dtype) for t in [x, *ws]]
            ms, outs = {}, {}
            for rt in lstm._ROWS_PER_BLOCK:
                lstm._rows_per_block = lambda rows, n, rt=rt: rt
                outs[rt] = lstm.lstm_scan_fused(*args)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    lstm.lstm_scan_fused(*args)
                end.record()
                torch.cuda.synchronize()
                ms[rt] = start.elapsed_time(end) / 5
            lstm._rows_per_block = picker
            same = all(torch.equal(outs[rt], outs[lstm._ROWS_PER_BLOCK[0]]) for rt in outs)
            print(json.dumps({"shape": label, "rows": R, "steps": T,
                              "dtype": str(dtype).replace("torch.", ""),
                              "ms_by_rows_per_block": ms, "picked": picker(R, n_sm),
                              "outputs_identical": same}), flush=True)


if __name__ == "__main__":
    main()
