"""Time the same benches of two checkouts of the repo in one run, in the
order A, B, B, A, each run a fresh process that imports ``nlsolver_torch``
from its checkout.  Prints one JSON object a run and, last, every
numeric figure side by side with the ratio B / A of their means.

    python -m nlsolver_torch.benches.compare OLD_TREE NEW_TREE \\
        "bench_pso_sann_100d(B=256)" "bench_de_batched(fused=False)"
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_RUN = """
import json, sys, torch
import nlsolver_torch.benches as b
out = {call: eval("b." + call) for call in sys.argv[1:]}
out["device"] = torch.cuda.get_device_name(0)
print(json.dumps(out))
"""


def run_tree(tree: str, calls) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run([sys.executable, "-c", _RUN, *calls], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=3000)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    a, b, calls = argv[0], argv[1], argv[2:]
    runs = {a: [], b: []}
    for tree in (a, b, b, a):
        r = run_tree(tree, calls)
        runs[tree].append(r)
        print(json.dumps({"tree": tree, **r}), flush=True)
    rows = {}
    for call in calls:
        for key, va in runs[a][0][call].items():
            if isinstance(va, (int, float)) and not isinstance(va, bool):
                xa = [r[call][key] for r in runs[a]]
                xb = [r[call][key] for r in runs[b]]
                ma, mb = sum(xa) / len(xa), sum(xb) / len(xb)
                rows[f"{call}.{key}"] = {"A": xa, "B": xb, "B/A": mb / ma if ma else None}
    print(json.dumps({"A": a, "B": b, "figures": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
