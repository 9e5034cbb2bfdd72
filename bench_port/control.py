"""The controls of each cell's comparison: whole runs of the cell in
which a control answers every request in the program's place, so that
the cell's own comparison, in the harness, has to come out not correct.

Each request path names its controls (CONTROLS in kinds/<path>.py): an
answer one step below what the configuration states. For the decode
paths the plain reference, the labels the volume was made from, stored
one width narrower ("narrower") and in 8 bits ("narrowest"), read back
at their own width; "narrower" loses nothing where every label fits (the
connectomics volume's 3072 labels fit 16 bits), and "narrowest" breaks
the guarantee that every voxel's label is exact.

  python3 bench_port/control.py --workload <name> --seconds <s> \
    --seeds <n> [<n> ...]

runs the cell once a seed and control, at the cell's own size, and
prints the harness's result line of each, then a line with the seed,
the control, `correct` and the numbers compared beside their limits.
Not part of a benchmark run.
"""
import argparse
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
  sys.path[0] = ROOT

from bench_port import harness, paths  # noqa: E402


def main(argv, device="cuda", root=ROOT, overrides=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seconds", type=float, default=5.0)
  ap.add_argument("--seeds", type=int, nargs="+", required=True)
  args = ap.parse_args(argv)
  bench = harness.load_json(root, "BENCHMARK.json")
  cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
  here = os.path.join(root, bench["paths"][0])
  traffic = harness.load_json(here, "traffic", f"{cell['traffic']}.json")
  names = paths.kind(here, traffic["path"]).CONTROLS
  results = []
  for seed in args.seeds:
    for name in names:
      buf = io.StringIO()
      with contextlib.redirect_stdout(buf):
        rc = harness.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"],
                          device=device, root=root, overrides=overrides,
                          control=name)
      out = buf.getvalue().strip().splitlines()
      res = json.loads(out[-1]) if rc == 0 and out else None
      if res is not None:
        print(out[-1])
      line = {"workload": args.workload, "seed": seed, "control": name,
              "rc": rc, "correct": None if res is None else res["correct"],
              "checks": None if res is None else res["checks"]}
      print(json.dumps(line), flush=True)
      results.append(line)
  return results


if __name__ == "__main__":
  main(sys.argv[1:])
