"""The lower-precision control, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Puts the reference in the program's place with its CRI and MRC computed
in float32, the precision below the configuration's float64 (a trace: its
reuse histogram and MRC), and prints, for each seed, the numbers
``correct`` compares (against the float64 reference) for the predictions a
run with that seed would check, on the input a run with that seed makes
(a served cell: every tenant a run with that seed sends requests to).
A sound limit lies below every one of them.  The benchmark's runs never
run this; it needs the card.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from benchmark import compare, harness, traffic  # noqa: E402
from benchmark.reference import curve, trace  # noqa: E402


def readings(root: str, workload: str, seeds: list, device: str,
             window: int = 8) -> list[dict]:
    """Per seed, the control's numbers over the predictions a run checks
    (drawn as a run draws them, from the first ``window`` predictions)."""
    bench = harness.load_bench(root)
    _, config, mix = harness.cell_of(bench, workload, root)
    if harness.is_serve(config):   # every tenant a run with the seed sends
        from benchmark import serve
        return [{"workload": workload, **r} for r in serve.control(
            config, mix, seeds, bench["run_seconds"], device)]
    is_trace = harness.is_trace(config)
    memo, out = {}, []
    for seed in seeds:
        gen = traffic.predictions(mix, config, seed)
        preds = [next(gen) for _ in range(window)]
        nums = {"counts_off": 0, "cri_gap": 0.0, "mrc_gap": 0.0}
        if is_trace:   # a trace is the seed's own input
            memo.clear()
        with harness.inputs(config, seed, device) as data:
            for key in traffic.checked([p.key for p in preds], mix, seed):
                p = next(q for q in preds if q.key == key)
                if key not in memo:
                    h, rih, crv = harness.reference(config, mix, p, device,
                                                    data)
                    crih = trace.histogram(h, np.float32) if is_trace \
                        else curve.distribute(h.noshare, h.share,
                                              p.thread_num, np.float32)
                    memo[key] = (rih, crv, crih, curve.aet_mrc(
                        crih, config["cache_kb"], np.float32))
                rih, crv, crih, ccrv = memo[key]
                nums["cri_gap"] = max(nums["cri_gap"],
                                      compare.cri_gap(crih, rih))
                nums["mrc_gap"] = max(nums["mrc_gap"],
                                      compare.mrc_gap(ccrv, crv))
        out.append({"workload": workload, "seed": seed, **nums,
                    "correct": compare.judge(nums)})
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for r in readings(root, args.workload,
                      [int(s) for s in args.seeds.split(",")], "cuda"):
        print(json.dumps(r), flush=True)
