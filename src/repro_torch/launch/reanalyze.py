"""Re-cost the saved op traces with the current ``op_cost`` rules and
refresh the dry run's records, without tracing again (port of
``repro.launch.reanalyze``, which re-runs ``hlo_cost`` over the saved
``.hlo.gz``): iterate on the cost model without re-running the cells.

Run:  PYTHONPATH=src python -m repro_torch.launch.reanalyze
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR, load_trace
from repro_torch.launch.op_cost import analyze


def reanalyze(results_dir: str = RESULTS_DIR) -> int:
    """Refresh every record of ``results_dir`` that has a trace beside it;
    returns how many."""
    n = 0
    for jpath in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        tpath = jpath.replace(".json", ".ops.json.gz")
        if not os.path.exists(tpath):
            continue
        with open(jpath) as f:
            rec = json.load(f)
        if "error" in rec:
            continue
        hc = analyze(load_trace(tpath))
        rec["flops_per_device"] = float(hc["flops"])
        rec["bytes_per_device"] = float(hc["traffic_bytes"])
        rec["transcendentals"] = float(hc["transcendentals"])
        rec["collectives"] = hc["collectives"]
        rec["collective_bytes_per_device"] = float(hc["collective_bytes"])
        rec["kernels"] = hc["kernels"]
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    return n


def main() -> None:
    print(f"re-analyzed {reanalyze()} cells")


if __name__ == "__main__":
    main()
