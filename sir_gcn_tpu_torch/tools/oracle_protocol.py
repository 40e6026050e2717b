"""The synthetic oracles' multi-run protocol on one card: the reference's
README commands (500 epochs, batch 256, lr 1e-3, plateau 0.5/10) at 10
runs, seeds 0-9, for DictionaryLookup SIR and GCN at n=10 (h=40) and
HeteroEdgeCount SIR and GCN at c=2 (h=20, unnormalized).

    python -m sir_gcn_tpu_torch.tools.oracle_protocol [--deadline 2100]
        [--out build/oracle_protocol]

Each lane is one process of the port's trainer on the card, all started
together; HeteroEdgeCount SIR runs three lanes (seeds 0-3, 4-6, 7-9)
and GCN two (0-4, 5-9), since their runs are the longest. Each lane
writes its output to ``<out>/<lane>.log``. A lane still running at ``--deadline`` seconds is
stopped and counted by the runs it finished (its stderr lines). Prints
one line per configuration (runs finished, mean ± std, each run's
value, epochs and seconds) and then one JSON object with the same, the
card's name and power limit and the wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

DL = "sir_gcn_tpu_torch.experiments.dictionary_lookup.train"
HEC = "sir_gcn_tpu_torch.experiments.hetero_edge_count.train"
def _hec(model: str, seed: int, runs: int) -> list:
    return ["--model", model, "--classes", "2", "--nhidden", "20",
            "--nruns", str(runs), "--seed", str(seed)]


# lane: (configuration, module, flags)
LANES = {
    "dl_sir_n10": ("dl_sir_n10", DL, ["--nodes", "10", "--nhidden", "40",
                                      "--nruns", "10"]),
    "dl_gcn_n10": ("dl_gcn_n10", DL, ["--model", "GCN", "--nodes", "10",
                                      "--nhidden", "40", "--nruns", "10"]),
    "hec_sir_c2_s0": ("hec_sir_c2", HEC, _hec("SIR", 0, 4)),
    "hec_sir_c2_s4": ("hec_sir_c2", HEC, _hec("SIR", 4, 3)),
    "hec_sir_c2_s7": ("hec_sir_c2", HEC, _hec("SIR", 7, 3)),
    "hec_gcn_c2_s0": ("hec_gcn_c2", HEC, _hec("GCN", 0, 5)),
    "hec_gcn_c2_s5": ("hec_gcn_c2", HEC, _hec("GCN", 5, 5)),
}
RUN_LINE = re.compile(r"\[run \d+ seed (\d+)\] train \S+ (\S+) test \S+ "
                      r"(\S+) \((\d+) epochs, ([\d.]+) s\)")


def finished_runs(log_path: str) -> list:
    """(seed, train, test, epochs, seconds) of each run a lane's log
    reports as finished."""
    with open(log_path) as f:
        return [(int(m[1]), float(m[2]), float(m[3]), int(m[4]),
                 float(m[5])) for m in RUN_LINE.finditer(f.read())]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--deadline", type=float, default=2100.0,
                   help="seconds after which lanes still running stop")
    p.add_argument("--out", default="build/oracle_protocol",
                   help="directory of the lanes' logs")
    args = p.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs, files = {}, {}
    for lane, (_, module, flags) in LANES.items():
        files[lane] = open(os.path.join(args.out, f"{lane}.log"), "w")
        procs[lane] = subprocess.Popen(
            [sys.executable, "-m", module, *flags], stdout=files[lane],
            stderr=subprocess.STDOUT, env=env)
    cut = []
    try:
        for lane, proc in procs.items():
            left = args.deadline - (time.perf_counter() - t0)
            try:
                proc.wait(timeout=max(left, 0.0))
            except subprocess.TimeoutExpired:
                proc.terminate()
                proc.wait(timeout=60)
                cut.append(lane)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files.values():
            f.close()
    wall = time.perf_counter() - t0

    configs: dict = {}
    for lane, (config, _, _) in LANES.items():
        c = configs.setdefault(config, dict(runs=[], cut_lanes=[],
                                            failed_lanes=[]))
        c["runs"] += finished_runs(os.path.join(args.out, f"{lane}.log"))
        if lane in cut:
            c["cut_lanes"].append(lane)
        elif procs[lane].returncode != 0:
            c["failed_lanes"].append(lane)
    summary = {"device": smi, "wall_s": wall, "configs": {}}
    for config, c in configs.items():
        runs = sorted(c["runs"])
        test = [r[2] for r in runs]
        row = dict(n=len(runs), seeds=[r[0] for r in runs], test=test,
                   train=[r[1] for r in runs], epochs=[r[3] for r in runs],
                   seconds=[r[4] for r in runs],
                   mean=float(np.mean(test)) if test else None,
                   std=float(np.std(test)) if test else None,
                   cut_lanes=c["cut_lanes"], failed_lanes=c["failed_lanes"])
        summary["configs"][config] = row
        print(f"{config}: {len(runs)} runs, test {row['mean']} ± "
              f"{row['std']}; per run {test}; epochs {row['epochs']}; "
              f"seconds {row['seconds']}"
              + (f"; cut {c['cut_lanes']}" if c["cut_lanes"] else "")
              + (f"; FAILED {c['failed_lanes']}" if c["failed_lanes"]
                 else ""), flush=True)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    summary = main()
    sys.exit(1 if any(c["failed_lanes"]
                      for c in summary["configs"].values()) else 0)
