#!/usr/bin/env python3
"""Holds the numbers of chip_smoke.py runs of two trees side by side.

    python3 scripts/compare_smoke_runs.py parent=A.out,D.out change=B.out,C.out

Each argument is a label and the standard output of one or more runs of
chip_smoke.py on one tree (run them in one call to the card, in the order
parent, change, change, parent). For every number both labels measured, the
end-to-end ones (a decode's or a serving run's RTF, a training step's ms, a
streaming chunk's ms) and every kernel row's ms of the kernels line, it
prints one JSON line: the values of each label, each label's spread over its
runs (max / min - 1), and `delta` = mean of the second label / mean of the
first - 1 (positive: the second label's number is larger; `higher_is_better`
says which way is faster). `beyond_spread` is true where |delta| is larger
than both labels' spreads. The last line counts them.
"""
import json
import sys


def _key(d, *names):
    return "|".join(str(d[k]) for k in names if k in d)


def read(path):
    """{metric: (value, higher_is_better)} of one smoke run's output."""
    out = {}
    for line in open(path):
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if "kernels" in d:
            for k in d["kernels"]:
                name = "kernel:" + _key(k, "name", "shape", "mode", "rows", "steps", "H",
                                        "dilation", "dtype")
                out[name] = (k["ms"], False)
            continue
        phase = d.get("phase")
        tag = _key(d, "phase", "causal", "dtype", "fused_tcn", "stream_mode")
        if phase is None or "name" in d:
            continue
        if "rtf" in d:
            out[f"e2e:{tag}:rtf"] = (d["rtf"], True)
        elif "ms_per_step" in d:
            out[f"e2e:{tag}:ms_per_step"] = (d["ms_per_step"], False)
        elif "wall_ms_per_chunk_mean" in d:
            out[f"e2e:{tag}:ms_per_chunk"] = (d["wall_ms_per_chunk_mean"], False)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or not all("=" in a for a in argv):
        raise SystemExit(__doc__.split("\n\n")[1])
    labels = []
    for arg in argv:
        label, paths = arg.split("=", 1)
        labels.append((label, [read(p) for p in paths.split(",")]))
    (la, runs_a), (lb, runs_b) = labels
    common = set.intersection(*(set(r) for r in runs_a + runs_b))
    moved = 0
    for metric in sorted(common):
        va, vb = [r[metric][0] for r in runs_a], [r[metric][0] for r in runs_b]
        spread = {la: max(va) / min(va) - 1, lb: max(vb) / min(vb) - 1}
        delta = (sum(vb) / len(vb)) / (sum(va) / len(va)) - 1
        beyond = abs(delta) > max(spread.values())
        moved += beyond
        print(json.dumps({"metric": metric, la: va, lb: vb, "spread": spread, "delta": delta,
                          "higher_is_better": runs_a[0][metric][1],
                          "beyond_spread": beyond}))
    print(json.dumps({"metrics": len(common), "beyond_spread": moved}))


if __name__ == "__main__":
    main()
